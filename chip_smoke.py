#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. device  — requires CUDA; prints the card's name and power limit as
   ``nvidia-smi`` gives them.
2. build   — compiles every ``src/repro_torch/**/csrc/*.cu`` for sm_90a,
   one ``nvcc`` per source, all started together.
3. kernels — holds each hand-written kernel against its plain PyTorch
   version at the main paths' shapes (bitslice MVM at M in {1, 4, 16},
   and 20 at Qwen2.5-3B's, and both GF(2) MVM entries, int8 and state bytes, bit for bit, paged
   attention at the serve run's window T=81 and a long one, T=1024,
   within the stated tolerance and its pools bit for bit), checks that
   two calls on the same inputs give the same bits, and
   times kernel, plain version and one PyTorch library call that
   computes the same function, beside the card's least time (bound);
   then sums K1's and K2's times over the 7 x 36 projections of a
   decode step (M=4) and of a prefill chunk (M=16) beside their bound.
   The same for xLSTM-350M's 120 projections (1024 x 6144, 1024 x 4,
   1024 x 2048, 2048 x 1024): at N = 4, mLSTM's gates, the packed
   entries pad the planes to 16 columns a call, timed beside the same
   launches on planes padded once.  The same for OLMoE-1B-7B's 64
   projections (2048 x 2048, M = 4 and 16), and K3 at the MoE head
   layouts (KV = 16, G = 1, hd = 128 and KV = 8, G = 2, hd = 64, at
   the same (S, T) cases); then K3's store where 6 inactive rows and a
   past-width one write the same trash cells (S = 1 and 16): its pools
   bit-equal to the plain version's, the last row's value in each
   shared cell, as the reference's sequential scatter leaves it.  Every
   K3 case holds the pools bit for bit, trash block included.  The same
   for Jamba-v0.1's 44 projections of a period (in 4096 x 16384, x 8192
   x 288, dt 256 x 8192, out 8192 x 4096, q/o 4096 x 4096, k/v 4096 x
   1024, gate/up 4096 x 14336, down 14336 x 4096; M = 4 and 16) and K3
   at its layout (KV = 8, G = 4, hd = 128) at the same (S, T) cases.
   Then K3 through the prefix cache's write table (``SHARED_COLS``: a
   chunk of 16 at T = 81 whose rows store across shared and private
   columns): its pools bit-equal to the plain version's, every block of
   a shared column unchanged bit for bit.  Then phase 13's shapes
   (``check_family_kernels``): K1 and K2 at glm4-9b's and minicpm-2b's
   projections (M = 4), command-r-plus-104b's (M = 4 and 16: 12288 x
   33792 and 33792 x 12288, the repo's largest, K split over a cluster)
   and whisper-tiny's encoder (M = 6000), bit for bit; K3 at glm4-9b's
   G = 16 and command-r's G = 12 (one position's heads over two CTAs of
   8 queries) and minicpm-2b's KV = 36, G = 1, hd = 64, at S = 1, 4 and
   16 over T = 81 and S = 1 over T = 1024, pools bit for bit.  Then
   phase 16's shapes (``check_encoder_mvm``): K1 and K2 at the encoder's
   768 x 768, 768 x 3072 and 3072 x 768 at M = 4096 (8 x 512 tokens),
   bit for bit, timed beside their bounds and ``torch._int_mm``.
4. serve pum  — ``repro_torch.launch.serve.main`` on Qwen2.5-3B at full
   width with prepacked ``pum`` weights: 4 slots, KV blocks of 16,
   chunked prefill, a burst of 6 requests of 20..64 prompt tokens, 16
   greedy tokens each.  The scheduler runs every decode step and prefill
   chunk as a CUDA graph replay, building one graph for decode and one
   per chunk length; the decode graph holds the sampler, whose greedy
   rows take the argmax (phase 8).  Checks every completion, the launch counts per
   decode step and prefill chunk (replays counted), and that each step
   was built once.  Then: one chunk and one decode step from a fresh
   pool with graphs on and off, logits bit-equal; the same trace again
   on the same scheduler (nothing new built, the same tokens) and on
   one with ``cuda_graphs=False`` (the same tokens and launches), their
   decode ms/step, tokens/s and peak memory side by side; one prefill
   chunk and one decode step on the ``cuda`` and the ``torch`` backends,
   logits compared; the f32 lm head's device time as a share of one
   decode graph replay's; the card's busy share under the profiler,
   graphs and eager.  Then the prefix cache (``prefix_check``): a trace
   of six requests over one 48-token prefix (the whole prefix, two
   slices, two extensions, the whole prefix again at step 8) served
   with the cache cold and warm and without it: completions equal bit
   for bit, the hits, tokens skipped and blocks shared the trace
   implies (``PREFIX_STATS``), the launch counts of each run, each step
   built once and nothing new warm, no block live after a drain and a
   flush; prefill chunks, seconds and tokens/s of the three runs.
5. serve int8 — the same with ``int8`` weights; then the CLI with
   ``--no-prepack`` on the same trace (``no_prepack_run``: the float
   weights quantised every call, K2's unpacked entry in the graphs):
   the prepacked run's tokens, the same launches a step or chunk.
5b. serve bf16 — the same with the float weights unpacked: no MVM
   kernel launches, K3 one a layer a step and chunk.
6. aes — ``repro_torch.launch.aes.main`` at 2^24 blocks (256 MiB of
   plaintext) for AES-128, -192 and -256: the bulk cipher through K4's
   state-byte entry, its ciphertext against the numpy oracle on 65 536
   strided blocks, decrypt(encrypt(x)) == x on every block, exactly Nr
   (Nr - 1) launches of that entry per encrypt (decrypt) call and none
   of K4's int8 entry, the gate-accurate DCE path on 256 blocks equal
   to the bulk ciphertext, the FIPS-197 vectors through every path on
   the card, the card's busy share over one bulk encryption under the
   profiler, and (AES-128) the device time of each op of one round.
7. cnn — ResNet-20 for CIFAR-10 at its published width (16/32/64
   channels, 20 layers) on 1024 synthetic images, every conv an im2col
   MVM: first K2's unpacked entry at each layer's shape (up to 2^20 rows,
   past CUDA's 65535 CTAs on grid z; N down to 10) bit for bit against
   its plain version, timed beside its byte bound and ``torch._int_mm``;
   then the ``pum`` forward with exactly 22 K2 launches (and none of
   K1), its logits bit-equal to the ``torch`` backend's and across two
   runs, and finite; the float forward (f32 ``torch.matmul``, TF32 off)
   and the two modes' argmax agreement; images/s of both; K2's share of
   a forward's device time and the top kernels under the profiler; and
   the paper's §7.5 agreement sweep (programming noise sigma in {0,
   0.02, 0.05, 0.1, 0.3}, 256 images) with its gates: agreement
   without noise at least 0.75, at sigma 0.3 no higher, noise drawn
   (on differs from off) from the generator (the same seed gives the
   same bits).
8. sampled — the sampler (``serve/prng.py``, ``sample_token``) on the
   card: threefry's known answers; random bits and uniforms over a
   decode step's [4, 152064] logits (one key, and a key a row)
   bit-equal to the CPU's; Gumbel values within 2 ulps of the CPU's;
   categorical draws over 64 rows equal to the CPU's but at near-ties,
   counted; 2^20 rows, a key each, drawing from one 16-way categorical
   at t = 0.7, every frequency within 5 sigma of ``softmax(l / t)``;
   the sampler's device ms at a decode step's shapes.  Then in ``pum``
   and ``int8``: the CLI at ``--temperature 0.7`` (the main path), and
   on its scheduler phase 4's six requests at temperatures [0, 0.7, 1,
   0, 0.7, 1], a seed each, gated: each of the first three (one at each
   temperature) equal to the request served alone through the same
   kernels, and on the ``torch`` backend (where the scheduler and the
   contiguous solo loop run the same arithmetic) to its solo
   ``generate_loop``; the tokens of phase 4's speculative run of the
   trace (``pum``); graphs and eager equal in
   tokens and launches; the temperature-0 requests equal to phase 4's
   tokens; one decode program and nothing new built; the same seeds the
   same tokens and other seeds other tokens; at t = 1 some token off the
   greedy one; 252 MVM + 36 attention launches a step or chunk; in
   ``pum``, where the cuda backend's completions first differ from the
   contiguous solo loop on the cuda backend (printed, not gated); decode
   ms/step
   (graphs and eager), tokens/s, a decode replay's device ms and the
   sampler's share of it; greedy decode ms/step of phases 4-5b beside
   those recorded before the decode graph held the sampler (PERF.md).
9. contiguous — the reference's default serving paths, in ``pum`` and
   ``int8``, on Qwen2.5-3B at full width cut to CONTIG_LAYERS = 6 of
   its 36 layers (phases 4-8 serve all 36): one layer's online softmax (``_chunked_attention``) at a
   4096-token prompt's shapes against the plain composition, within the
   bound derived at CHUNK_ATTN_REL; K1 and K2 alone at M = 4096 (a
   monolithic prefill's rows) bit for bit, timed beside their bounds and
   ``torch._int_mm``.  Then the CLI with ``--kv-block-size 0`` on phase
   4's trace (contiguous windows: one prefill program a prompt length,
   one decode program, no K3), gated: 7 MVM launches a layer a step
   and a prefill and none of K3, each program built once, the same trace
   again building nothing, graphs == eager, and the tokens equal to
   the paged scheduler's on the ``torch`` backend with monolithic
   prefill on both; then phase 8's six requests plus one of 4096
   prompt tokens (its prefill through the online softmax) on a
   scheduler of 4113 positions, each completion equal to the request
   served alone through ``generate_loop`` on the ``cuda`` backend, and
   the long prefill timed (time to first token) and profiled; then the
   static batch (``--batch-slots 0 --batch 4 --prompt-len 64 --gen
   16``), compiled prefill and decode step and ``--loop``, at t = 0 and
   0.7, gated equal token for token, seeds reproducing with nothing new
   built, half the steps replaying the same two programs, graphs ==
   eager; its rate build included and steady.  Prints decode ms/step (graphs and eager), tokens/s,
   peak memory, and a decode replay's device ms beside the paged
   scheduler's on the same trace, timed in turns (paged, contiguous,
   contiguous, paged).
10. xlstm — xLSTM-350M at full width cut to 8 of its 24 layers (6
   mLSTM + 2 sLSTM, ``XLSTM_SERVE_LAYERS``; random weights), in
   ``pum`` and ``int8``: the CLI on phase
   4's trace paged (blocks of 16, chunked prefill; no KV, so 0 blocks a
   request) and with ``--kv-block-size 0``, then on both schedulers
   phase 8's six sampled requests (16 tokens each in ``pum``, 8 in
   ``int8``), gated: each completion equal to the
   request served alone through ``generate_loop`` on the ``cuda``
   backend, in both layouts; the greedy runs paged == contiguous; a
   second run builds nothing; one decode program; graphs == eager in
   tokens and launches; each recurrent step built and called once
   leaves the state one eager call leaves (fresh schedulers, step by
   step); 40 MVM launches a step, chunk or prompt and no K3; states
   and every step's last logits finite; backend parity; then the static
   batch (scan == ``--loop``, t = 0).  Prints decode ms/step (graphs and
   eager), tokens/s, a decode replay's device ms with K1's or K2's
   share (profiler) and the recurrences' (the cells timed alone), a
   64-token prompt's prefill device ms, graph build seconds, the
   recurrent bytes a slot beside Qwen2.5-3B's KV bytes, and the phase's
   seconds.  In ``pum``, phase 4's prefix-cache check, where the cache
   holds recurrent snapshots and no block, then one 4096-token prompt
   served twice with the cache (``long_snapshots``): the warm run
   resumes at the snapshot of its 255th block edge and gives the cold
   run's tokens; the snapshots' count and bytes against the budget.
11. moe — OLMoE-1B-7B at full width and depth (16 layers, d_model
   2048, 64 experts top-8, random weights; 25.8 GB of f32 expert
   stacks), in ``pum`` and ``int8``: the CLI on phase 4's trace paged
   (blocks of 16, chunked prefill) and with ``--kv-block-size 0``, at
   the config's own capacity factor 1.25 (capacity 1 an expert at a
   decode step), gated: 64 MVM launches a step, chunk or prompt (q, k,
   v, o: none for the f32 router or the float experts), 16 K3 a paged
   one and none contiguous; each program built once; the same trace
   from a fresh state (idle rows take capacity, so a run depends on
   what the last one left) the CLI's tokens twice, building nothing;
   graphs == eager in tokens and launches; every step's logits finite;
   the ``cuda`` and ``torch`` backends on one chunk and one step,
   routed alike (``routing``: the torch run and a run with layer 0's
   input nudged by one bf16 ulp take the cuda run's experts): logits
   within the nudge's change, greedy tokens equal, router
   probabilities within the nudge's change (the router's one-ulp
   sensitivity), and every row where the torch router would choose
   other experts at a near-tie (the cuda run's probabilities of the
   two experts within that sensitivity), counted.  Then at capacity
   factor E / k (no drops), paged and contiguous, each against every
   request alone through ``generate_loop`` on ``cuda``: an eager run
   with every row routed as its request alone routed it keeps the
   router probabilities within the sensitivity, differs in its own
   choices only at router near-ties, and first differs in tokens only
   where the solo's top-2 margin is within the one-ulp logit bound
   (both measured by the backend parity at this factor); the free runs
   (graphs == eager) first differ where the held run does or after a
   router near-tie.  The expert products' row count is the capacity
   and K3 sums in another order than the solo's attention, so the
   logits are not bit-equal; the share of solo margins and router gaps
   within the thresholds is printed.  Then the static batch (scan ==
   ``--loop``, t = 0).  granite-moe-1b-a400m (24 layers, 32 experts,
   GQA G = 2, hd 64) once through the paged CLI in ``pum``: launches,
   builds, a fresh-state rerun, finite logits.  Prints decode ms/step
   (graphs and eager), tokens/s, a decode replay's device ms and its
   split under the profiler (K1/K2, K3, the cast's copies, float
   GEMMs, sort and ranks, gathers), the expert cast, the expert
   products and the rest of one layer's ``moe_ffn`` timed alone, a
   64-token prefill's device ms, the share of assignments dropped a
   decode step, peak memory and the phase's seconds.
12. hybrid — Jamba-v0.1 at full width cut to one period of 8 layers (7
   Mamba + 1 attention mixers, 4 dense MLPs + 4 MoE FFNs of 16 experts
   top-2; 45.1 GB of f32 expert stacks; its 32 layers would hold 180 GB),
   random weights, in ``pum`` and ``int8``: the CLI (``main(cfg=...)``)
   on phase 4's trace paged and with ``--kv-block-size 0``, at the
   config's own capacity factor 1.25, gated as phase 11: 44 MVM launches
   a step, chunk or prompt (none for the router, the experts, the conv
   or the recurrence), 1 K3 a paged one and none contiguous; each program
   built once; the same trace from a fresh state the CLI's tokens twice,
   building nothing; graphs == eager in tokens and launches; the SSM
   states and every step's last logits finite; backend parity with the
   routing held; at E / k against every request alone (phase 11's
   no-drop gates); the static batch (scan == ``--loop``, t = 0).  Then
   the same period with its MoE FFNs made dense (all 8 MLPs), ``pum``,
   phase 8's sampled requests: each completion equal to its request
   alone through ``generate_loop`` on ``cuda`` (contiguous windows) and
   on the ``torch`` backend (paged), bit for bit; paged on ``cuda`` the
   first differences (K3's order) counted; then phase 4's prefix-cache
   check on that period, shared KV blocks and Mamba snapshots together.  Prints phase 11's numbers
   (a decode replay's split, the expert cast and products alone, a
   64-token prefill, the dropped share), the Mamba layers' conv and
   recurrence timed alone and their share of a replay, the SSM state
   bytes a slot, the KV bytes a token, peak memory and the phase's
   seconds.
13. families — the rest of the reference's registry at full width,
   random weights packed at load layer by layer: glm4-9b (cut to
   FAMILY_LAYERS = 20 of its 40 layers, GQA 32/2, hd 128) in ``pum`` and
   ``int8``, minicpm-2b (20 of 40 layers, MHA 36 x 64, tied embeddings,
   vocabulary 122 753) and command-r-plus-104b
   cut to CR_LAYERS = 6 of its 64 layers (d_model 12288, d_ff 33792,
   GQA 96/8; its packed layers and f32 tied embedding at 64 layers hold
   516 GB) and llava-next-mistral-7b's text (32 layers) in ``pum``, each
   through the paged CLI on phase 4's trace (``main(cfg=...)`` for the
   cut), gated as phase 11's granite run: the launch counts (7 MVM and
   1 K3 a layer a step or chunk), each program built once as a graph,
   a fresh-state rerun building nothing with the same tokens, every
   step's logits finite, and backend parity (``backend_parity``: cuda
   against torch logits on one chunk and one step within the one-ulp
   nudge's change, greedy equal).  Then llava's image path on the same
   params: one ``lm.forward(image_embeds=)`` over 2880 image embeddings
   and a 16-token prompt into contiguous states (225 MVM, no K3; 2896
   positions take the online softmax) and 8 greedy steps through
   ``ServeEngine.decode`` on ``cuda``, on ``torch`` and nudged, the
   logits within the nudge's change, the same tokens, finite.  Then
   whisper-tiny (4 + 4 layers) in ``pum``: ``ServeEngine.generate(
   encoder_frames=)`` on 4 requests of 1500 frames, 16 tokens each
   (prefill 24 encoder + 40 decoder MVM, 40 a decode step, 8 of them
   the cross K/V over 6000 rows; no K3), gated: the compiled loop ==
   ``generate_loop`` == the ``torch`` backend's tokens, two programs
   built once, other frames other tokens.  Prints decode ms/step,
   tokens/s, a decode replay's device ms, peak memory, and the phase's
   seconds.
Speculative decoding (``spec_check``; SPEC_K = 3, the card's main
   depth: 4 slots x 4 rows fill one K1/K2 row tile).  Phase 3 holds K3
   at the verify shape (Qwen2.5-3B's heads, B = 4, S = 4, T = 81, one
   row inactive, one whose last drafts pass the table width) against
   its plain version, pools bit for bit, timed beside SDPA and its
   bound, and prints how often a row of the RMSNorm, of the f32 lm head
   and of a ``bf16`` projection takes other bits at 1 to 20 rows than
   at 4 (``check_row_invariance``; the verify step runs its norms and
   float products position by position).  In phases 4, 5 and 5b (Qwen2.5-3B ``pum``,
   ``int8``, ``bf16``), 10 (xLSTM-350M ``pum``) and 12 (Jamba's
   dense-FFN period), on the params
   the phase holds: the phase's trace at k = 3 with the n-gram drafter
   and with a replay of the k = 0 completions, both equal to the k = 0
   tokens bit for bit; the launch counts of every run (a verify step
   captures 252 MVM + 36 K3 at Qwen2.5-3B); one spec program and no
   decode program, each step built once as a graph; on a burst of
   exactly 4 requests from a fresh state at k = 0 and at k = 3 (each
   drafter) the pools bit-equal but for the trash block 0 and the
   recurrent rows (mLSTM/sLSTM c, n, m; Mamba h and conv) bit-equal.
   Phase 4 also runs k = 4 (replay: 20 rows, a second row tile) and
   phase 8's sampled trace at k = 3, whose tokens phase 8 gates against
   its own.  Prints the acceptance rate, advance a step, decode ms/step
   and tokens/s at k = 0, 3 and 4, a verify replay's device ms beside a
   decode replay's, and the per-position recurrent state bytes.
14. frontend — the resilient front end (``serve.frontend.ServeFrontend``,
   ``serve.policies``, ``serve.chaos``, ``ft``) over Qwen2.5-3B at full
   width, one scheduler a layout.  (a) The CLI under a storm: phase 4's
   geometry in ``pum``, ``--frontend --workload poisson --requests 12
   --max-queue 6 --policy edf --chaos STORM --deadline-ms 300`` on a
   virtual clock; gated: every rid resolves typed, faults were
   injected, some requests end ``ok`` and some ``expired`` with a
   non-empty truncated partial, each ``ok`` request's tokens equal bit
   for bit its tokens from a fault-free ``sched.run`` of the same trace
   on the same scheduler and each partial is a prefix of them, the
   launches equal the per-pass counts times the steps and chunks
   actually dispatched (a faulted dispatch launches nothing), nothing in
   flight and no block live after it, and a second storm with the same
   seed gives the same statuses, attempts, tokens and launches and
   builds no step.  (b) Real time on that scheduler: phase 4's six
   requests through the asyncio loop (``start``, ``submit``, ``async
   for ... stream()``, ``stop(drain=True)``) on ``time.monotonic``,
   each stream equal to its result and to the fault-free tokens; prints
   the wall-clock TTFT and ITL p50/p99 and tokens/s of
   ``metrics.snapshot()``; then one handle cancelled mid-decode and a
   ``PreemptionHandler.request_stop()`` mid-trace: typed outcomes,
   prefixes, a clean pool.  (c) The contiguous layout: the CLI with
   ``--kv-block-size 0 --frontend --chaos STORM`` in ``int8`` at
   ``CONTIG_LAYERS`` layers (no chunk fault can fire): every rid
   resolves, survivors equal the fault-free run, launches exact.  The
   virtual-clock milliseconds of (a) and (c) are functions of the
   trace, not times of the card.
15. train — the training path (``train/``, ``optim/``, ``ckpt/``,
   ``data/``, the straight-through gradient of ``pum_linear``) under
   deterministic algorithms (``CUBLAS_WORKSPACE_CONFIG`` is set for the
   whole run, before the CUDA context).  Phase 3 first holds K2's
   unpacked entry (``bitslice_mvm``, planes sliced per call) at
   Qwen2.5-3B's four projection shapes at M = 512 (B = 4 x S = 128), in
   ``pum`` (4 planes) and ``int8`` (one), bit for bit and timed beside
   its bound and ``torch._int_mm`` (``train_shapes`` of K2's row).
   Then, at Qwen2.5-3B's widths cut to 2 layers in ``pum`` and ``int8``:
   a loss and its gradients launch exactly 7 K2 a layer forward and 7
   recomputed (remat), nothing else; the ``torch`` backend launches
   nothing and gives the same loss and gradients bit for bit (its
   recomputation runs on the backward's own thread); remat off launches
   7 a layer, bit for bit the same; two microbatches equal one batch
   within MICRO_TOL (``bf16`` mode, f32 activations).  Then Qwen2.5-3B
   at full width and depth through ``Trainer`` in ``pum``, ``int8`` and
   ``bf16``, six steps on one repeated batch: exactly 504 K2 launches a
   quantised step and none in ``bf16``, finite losses falling, finite
   params; prints step ms (the median after two), tokens/s, peak
   memory, the allocator's retries, and a profiled step's device ms and
   K2's ms in it (with ``--profile-host`` the host's busiest operators
   too, some 20 s a mode).  Then the reduced
   config's run stopped by the preemption flag after 3 of 6 steps and
   resumed from its checkpoint (a temporary directory the phase
   removes): params and optimiser state bit-equal to an unbroken run;
   then OLMoE-1B-7B at full width cut to 2 of 16 layers: one step with
   the aux losses and the router's gradient finite and non-zero.
16. encoder — the paper's LLM encoder (§5.2, ``apps/encoder_app.py``)
   and ``pum.ibert``.  First each I-BERT function
   (``core/ibert.py``) at the encoder's shapes (softmax over [8, 12,
   512, 512], GELU over [8, 512, 3072], LayerNorm over [8, 512, 768]):
   on the card bit-equal to the CPU and across two calls, timed beside
   its byte bound and the float function it replaces.  Then the encoder
   at RoBERTa-base's published widths (12 layers, d_model 768, d_ff
   3072, 12 heads, vocabulary 50265; weights from a seed on the card)
   on 8 x 512 tokens, in ``pum`` and ``int8`` prepacked, both raw, and
   ``bf16``, each with I-BERT off and on: exactly 72 K1 launches a
   ``pum`` prepacked forward, 72 K2 in the others but ``bf16`` (none),
   K3 and K4 never; the ``torch`` backend bit-equal, two runs bit-equal,
   raw == prepacked in ``int8`` and ``pum``, finite; ms a forward and
   sequences/s; printed, the cosine of I-BERT's hidden states with the
   float path's and the top-1 agreement of ``encoder_logits`` (``pum``,
   at 2 and 12 layers), the I-BERT softmax's all-zero rows, and the
   profiler's split of a ``pum`` I-BERT forward (K1, the einsums'
   GEMMs, each I-BERT function, the rest).  Then ``pum.ibert`` through
   the language model: whisper-tiny's ``generate(encoder_frames=)`` as
   phase 13 runs it (the I-BERT softmax over 1500 frames and the
   cross-attention; its gates), and Qwen2.5-3B at full width cut to
   ``IBERT_QWEN_LAYERS`` layers through the paged CLI on phase 4's
   trace: K1 alone (no K3: the paged branch takes the I-BERT softmax in
   the plain composition), graphs == eager and ``cuda`` == ``torch``
   logits bit for bit.
17. a ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line.
   Every kernel of the main paths (phases 4-16) must have launched there;
   K4's int8 entry is on none of them (its ``launches`` is 0, and any
   launch there fails the run): phase 3 holds it against its plain
   version.  K2's row carries its rows at the CNN's layer shapes
   (``cnn_shapes``), K1's and K2's their rows at M = 4096
   (``prefill_shape``), at xLSTM-350M's shapes (``xlstm_shapes``) and
   at OLMoE-1B-7B's (``moe_shapes``) and at Jamba-v0.1's
   (``hybrid_shapes``), K3's at the MoE head layouts (``moe_shapes``),
   at Jamba's (``hybrid_shapes``) and at the verify shape
   (``verify_shape``); K1's, K2's and K3's at phase 13's shapes
   (``family_shapes``); K2's at the training shapes (``train_shapes``);
   K1's and K2's at the encoder's (``encoder_shapes``).
   The launches count the spec runs' verify steps and phase 15's
   full-width training steps.

``--only kernels`` stops after phase 3 (bring-up of a kernel change);
``--only cnn`` runs phases 1, 2 and 7 alone, ``--only contiguous``
phases 1, 2 and 9, ``--only xlstm`` phases 1, 2, phase 3's xLSTM
shapes and 10, ``--only moe`` phases 1, 2, phase 3's MoE shapes and
11, ``--only hybrid`` phases 1, 2, phase 3's Jamba shapes and 12,
``--only families`` phases 1, 2, phase 3's phase-13 shapes and 13,
``--only frontend`` phases 1, 2 and 14, ``--only train`` phases 1, 2,
phase 3's training shapes and 15, ``--only encoder`` phases 1, 2, phase
3's encoder shapes and 16.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# published peaks of the card (NVIDIA data sheets, dense):
# (device-memory bytes/s, bf16 flop/s, int8 op/s)
PEAKS = {"SXM": (3.35e12, 989e12, 1979e12),
         "PCIe": (2.0e12, 756e12, 1513e12)}

# K3's tolerance against its plain version, bf16 pools: the kernel sums
# scores and p*V in f32 in another order than the composition, so a
# probability can round to the neighbouring bf16 value (2^-8 relative)
# and the output to the neighbouring bf16 value; with O(1) inputs that
# is within 2e-2 absolute + 2e-2 relative.  Each case must also be
# within a bound read in the same run, which scales with the outputs
# (at T=1024 they are some 20 times smaller than at T=81): the plain
# version's own change when every V cell moves up by one bf16 ulp (times
# 1 + ULP), one to two ulps of the largest outputs.
ATTN_ATOL = 2e-2
ATTN_RTOL = 2e-2

# cuda-vs-torch backend logits of the full model (bf16 activations):
# every linear is exact integer arithmetic on equal inputs (bf16 mode:
# the same float matmul on both backends), so the two
# backends can differ only through attention's f32 summation order,
# which can move a bf16 activation by one ulp.  The bound is read in
# the same run: the logits' change when one bf16 ulp is added to every
# other channel of layer 0's attention input (its norm scale times
# 1 + ULP).  The greedy token must be the same on every row.
ULP = 2.0 ** -7


def log(msg: str) -> None:
    print(msg, flush=True)


def peaks(name: str) -> tuple[float, float, float]:
    return PEAKS["PCIe" if "PCIe" in name else "SXM"]


def share(bound: float, ms: float) -> str:
    """The kernel's share of its bound: bound time over measured time."""
    return f"{100 * bound / ms:.1f} %"


def device_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Per-call device time of ``fn``: ``iters`` calls captured in one
    CUDA graph and replayed between CUDA events, so host dispatch does
    not enter the number."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def event_ms(fn, reps: int = 5) -> float:
    """Per-call device time of ``fn`` between CUDA events, after one
    warm-up call: for calls of milliseconds on inputs far larger than
    the L2 cache, where launch time does not matter and a graph of many
    calls would hold their outputs at once."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Rotating:
    """Copies of a call's inputs cycled between launches so that their
    total exceeds the 50 MB L2 cache: every launch finds its weights
    cold, as on the main path, where 36 layers' weights pass between
    two uses of one."""

    def __init__(self, make, nbytes: int, total: int = 192 << 20):
        self.items = [make() for _ in range(max(1, min(64, -(-total //
                                                             max(nbytes,
                                                                 1)))))]
        self.i = 0

    def next(self):
        self.i = (self.i + 1) % len(self.items)
        return self.items[self.i]


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

MVM_SHAPES = [(2048, 2048), (2048, 256), (2048, 11008), (11008, 2048)]
# 16 rows: a prefill chunk, or a verify step at k = 3 (Qwen2.5-3B's
# sweep adds 20, a verify step at k = 4: a full row tile and a partial
# one)
MVM_ROWS = [1, 4, 16]
# Qwen2.5-3B's projections of one layer by (K, N): q and o, k and v,
# gate and up, down; 36 layers
MVM_PER_LAYER = {(2048, 2048): 2, (2048, 256): 2, (2048, 11008): 2,
                 (11008, 2048): 1}
LAYERS = 36
STEP_ROWS = {4: "decode step", 16: "prefill chunk or verify step (k = 3)",
             20: "verify step (k = 4)"}


def deterministic(fn) -> bool:
    """Two calls of ``fn`` on the same inputs give the same bits."""
    import torch
    a, b = fn(), fn()
    torch.cuda.synchronize()
    return torch.equal(a, b)


def mvm_ops(m: int, k: int, n: int) -> int:
    """The int8 operations of a bit-sliced MVM over any number of planes:
    sum_s (x @ P_s) << bps*s equals x @ (sum_s P_s << bps*s) exactly in
    int32, and that sum is the int8 weight the planes were sliced from,
    so the least work is one [M,K] x [K,N] int8 product."""
    return 2 * m * k * n


def mvm_case(dev, g, m: int, k: int, n: int, planes, one) -> dict:
    """K1 (``bitslice_mvm_planes_scaled``, 4 planes) and K2
    (``bitslice_mvm_planes``, the int8 weight as one plane) at one
    shape: bit for bit against their plain versions, two calls equal,
    then timed with the weights rotated past the L2 cache, beside the
    plain versions, ``torch._int_mm`` and their bounds."""
    import torch
    from repro_torch.kernels import registry
    from repro_torch.kernels.bitslice_mvm import ops
    bw, _, int8_rate = peaks(torch.cuda.get_device_name(dev))
    x = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                      dtype=torch.int32).to(torch.int8)
    scale = torch.rand((m, 1), generator=g, device=dev) * 1e-3
    got1 = ops.bitslice_mvm_planes_scaled(x, planes, scale, backend="cuda")
    ref1 = ops.bitslice_mvm_planes_scaled(x, planes, scale, backend="torch")
    got2 = ops.bitslice_mvm_planes(x, one, bits_per_slice=8, backend="cuda")
    ref2 = ops.bitslice_mvm_planes(x, one, bits_per_slice=8, backend="torch")
    got4 = ops.bitslice_mvm_planes(x, planes, backend="cuda")
    torch.cuda.synchronize()
    exact = (torch.equal(got1, ref1) and torch.equal(got2, ref2)
             and torch.equal(got4, ref2))
    err1 = (got1 - ref1).abs().max().item()
    err2 = (got2 - ref2).abs().max().item()
    if not exact:
        raise AssertionError(
            f"bitslice_mvm not bit-exact at M={m} K={k} N={n}: scaled "
            f"max|diff|={err1}, int max|diff|={err2}, 4-plane int equal="
            f"{torch.equal(got4, ref2)}")
    if not (deterministic(lambda: ops.bitslice_mvm_planes_scaled(
            x, planes, scale, backend="cuda"))
            and deterministic(lambda: ops.bitslice_mvm_planes(
                x, one, bits_per_slice=8, backend="cuda"))):
        raise AssertionError(f"bitslice_mvm differs between two calls at "
                             f"M={m} K={k} N={n}")
    npad = -(-n // ops.VEC) * ops.VEC
    splits = ops.mvm_plan(m, k, npad, 4, registry.device_props(
        dev.index)).splits
    # timings with the weights rotated past the L2 cache
    rp = Rotating(lambda: planes.clone(), planes.numel())
    rw = Rotating(lambda: one.clone(), one.numel())
    xpad = torch.zeros((max(32, -(-m // 8) * 8), k), dtype=torch.int8,
                       device=dev)
    xpad[:m] = x
    t1 = device_ms(lambda: ops.bitslice_mvm_planes_scaled(
        x, rp.next(), scale, backend="cuda"))
    t2 = device_ms(lambda: ops.bitslice_mvm_planes(
        x, rw.next(), bits_per_slice=8, backend="cuda"))
    p1 = device_ms(lambda: ops.bitslice_mvm_planes_scaled(
        x, rp.next(), scale, backend="torch"), iters=5)
    p2 = device_ms(lambda: ops.bitslice_mvm_planes(
        x, rw.next(), bits_per_slice=8, backend="torch"), iters=5)
    # _int_mm takes N in multiples of 8: the library call at N < 8 reads
    # the weight padded to 8 columns
    wlib = torch.zeros((k, max(8, -(-n // 8) * 8)), dtype=torch.int8,
                       device=dev)
    wlib[:, :n] = one[0]
    rl = Rotating(lambda: wlib.clone(), wlib.numel())
    lib = device_ms(lambda: torch._int_mm(xpad, rl.next()))
    # the planes recombine to wq exactly (mvm_ops), so the function's
    # work is one int8 GEMM; the planes' bytes count
    b1 = max((m * k + 4 * k * n + 4 * m + 4 * m * n) / bw,
             mvm_ops(m, k, n) / int8_rate) * 1e3
    b2 = max((m * k + k * n + 4 * m * n) / bw,
             2 * m * k * n / int8_rate) * 1e3
    if n % ops.VEC:
        # the same launches on planes padded once: the per-call pad's cost
        p1pad, p2pad = ops._padded(planes), ops._padded(one)
        t1p = device_ms(lambda: ops._launch(x, p1pad, scale.reshape(-1), 2))
        t2p = device_ms(lambda: ops._launch(x, p2pad, None, 8))
        log(f"mvm M={m} K={k} N={n}: planes padded to {npad} columns once, "
            f"K1 {t1p:.4f} ms, K2 {t2p:.4f} ms; the per-call pad adds "
            f"{t1 - t1p:.4f} / {t2 - t2p:.4f} ms")
    log(f"mvm M={m} K={k} N={n} (K1 split {splits} ways over K): exact, "
        f"two calls bit-equal | K1 scaled {t1:.4f} ms (plain {p1:.4f}, "
        f"bound {b1:.4f}, {share(b1, t1)} of bound) | K2 int8 {t2:.4f} ms "
        f"(plain {p2:.4f}, bound {b2:.4f}, {share(b2, t2)} of bound) | "
        f"_int_mm(M={xpad.shape[0]}) {lib:.4f} ms")
    return {"K1": dict(M=m, K=k, N=n, max_abs_err=err1, ms=t1, plain_ms=p1,
                       bound_ms=b1, bound_by="bytes", library_ms=lib),
            "K2": dict(M=m, K=k, N=n, max_abs_err=err2, ms=t2, plain_ms=p2,
                       bound_ms=b2, bound_by="bytes", library_ms=lib)}


def mvm_weights(dev, g, k: int, n: int):
    """A random int8 weight as K1's four planes and K2's one plane."""
    import torch
    from repro_torch.core import bitslice
    wq = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                       dtype=torch.int32)
    planes = bitslice.slice_planes_signed(wq, 8, 2).to(torch.int8)
    return planes, wq.to(torch.int8)[None]


def mvm_sweep(dev, shapes: dict, layers: int, label: str,
              rows: list[int]) -> list[dict]:
    """``mvm_case`` over ``shapes`` ((K, N) -> projections of that shape
    a forward pass) at each M of ``rows``; then K1's and K2's summed
    device time over a decode step (M=4), a prefill chunk or verify step
    at k = 3 (M=16) and a verify step at k = 4 (M=20), where ``rows``
    holds them, beside their bound.  Returns every case's row."""
    import torch
    g = torch.Generator(device=dev).manual_seed(0)
    step = {(name, m): [0.0, 0.0] for m in STEP_ROWS if m in rows
            for name in ("K1", "K2")}
    cases = []
    for (k, n), count in shapes.items():
        planes, one = mvm_weights(dev, g, k, n)
        for m in rows:
            case = mvm_case(dev, g, m, k, n, planes, one)
            cases.append(case)
            if m in STEP_ROWS:
                for name in ("K1", "K2"):
                    step[name, m][0] += count * case[name]["ms"]
                    step[name, m][1] += count * case[name]["bound_ms"]
    per_pass = sum(shapes.values())
    for (name, m), (ms, bound) in step.items():
        log(f"mvm {name} device time per {STEP_ROWS[m]} of {label} at M={m} "
            f"({per_pass} projections, {layers} layers): {ms:.3f} ms (bound "
            f"{bound:.3f} ms)")
    return cases


def check_mvm(dev) -> dict[str, dict]:
    """Phase 3's MVM checks at Qwen2.5-3B's shapes; K1's and K2's rows
    of the kernels line (M=4, 2048 x 11008)."""
    cases = mvm_sweep(dev, {s: LAYERS * c for s, c in MVM_PER_LAYER.items()},
                      LAYERS, "Qwen2.5-3B",
                      MVM_ROWS + [4 * (SPEC_K_WIDE + 1)])
    case = next(c for c in cases if (c["K1"]["M"], c["K1"]["K"],
                                     c["K1"]["N"]) == (4, 2048, 11008))
    return {name: {k: v for k, v in case[kern].items()
                   if k not in ("M", "K", "N")}
            for name, kern in (("bitslice_mvm_scaled", "K1"),
                               ("bitslice_mvm", "K2"))}


ATTN_CASES = [(1, 81), (16, 81), (1, 1024)]       # (S, T window)
# head layouts (KV heads, queries a KV head, head dim): Qwen2.5-3B's,
# then OLMoE-1B-7B's (MHA) and granite-moe-1b-a400m's
QWEN_HEADS = (2, 8, 128)
MOE_HEADS = [(16, 1, 128), (8, 2, 64)]


def _attn_case(dev, s: int, kv_len: int, seed: int, heads=QWEN_HEADS):
    """A head layout (default Qwen2.5-3B's) at the serve run's geometry:
    4 rows, blocks of 16, a table as wide as the T window (T = 81 is the
    serve run's, 6 columns; T = 1024 a long context).  Row 2 is inactive
    (its table is all trash); row 3 writes past its table width."""
    import torch
    (kvh, grp, hd), b, bs = heads, 4, 16
    w = -(-kv_len // bs)
    nb = 1 + b * w
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    q = rnd(b, s, kvh, grp, hd)
    k_new, v_new = rnd(b, s, kvh, hd), rnd(b, s, kvh, hd)
    k_pool, v_pool = rnd(nb, bs, kvh, hd), rnd(nb, bs, kvh, hd)
    table = torch.arange(1, nb, device=dev, dtype=torch.int32).reshape(b, w)
    table[2] = 0
    if s == 1:
        ci = [kv_len // 2, kv_len - 11, 5, w * bs + 3]
    elif s == SPEC_K + 1:
        # a verify step: row 3's last two drafts past the table width
        ci = [kv_len // 2 - 2, kv_len - s - 1, 0, w * bs - 2]
    else:
        ci = [kv_len // 2 - 8, kv_len - s - 1, 0, w * bs - 8]
    cache_index = torch.tensor(ci, dtype=torch.int32, device=dev)
    return (q, k_new, v_new, k_pool, v_pool, table, table.clone(),
            cache_index)


def _attn_bound(args, kv_len: int, bw: float, flops: float) -> float:
    q, k_new, _, k_pool, _, table, _, ci = args
    b, s, kvh, grp, hd = q.shape
    el = k_pool.element_size()
    nbytes = (q.numel() + 2 * k_new.numel()) * el          # q, new K/V in
    nbytes += 2 * k_new.numel() * el                       # cells stored
    nbytes += q.numel() * el + 2 * table.numel() * 4 + b * 4   # out, tables
    ops = 0
    for row in range(b):
        c = int(ci[row])
        nbytes += 2 * min(c + s, kv_len) * kvh * hd * el   # K and V read
        for si in range(s):
            ops += 4 * hd * min(c + si + 1, kv_len) * kvh * grp
    return max(nbytes / bw, ops / flops) * 1e3


def _v_nudged(args):
    """K3's inputs with every V cell, stored and new, one bf16 ulp up."""
    v_new, v_pool = args[2], args[4]
    return (args[:2] + ((v_new.float() * (1 + ULP)).to(v_new.dtype),)
            + args[3:4] + ((v_pool.float() * (1 + ULP)).to(v_pool.dtype),)
            + args[5:])


def check_attention(dev, gpu_name: str, layouts=(QWEN_HEADS,),
                    cases=ATTN_CASES) -> list[dict]:
    """K3 at each head layout and (S, T) case against its plain version:
    outputs within the stated tolerance, the pools bit for bit (the
    trash block too: where the inactive and the past-width row write one
    trash cell, the later row wins on both), two calls bit-equal; timed
    beside the plain version, ``scaled_dot_product_attention`` and the
    bound.  Returns every case's row."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import registry
    from repro_torch.kernels.paged_attention import ops, ref
    bw, flops, _ = peaks(gpu_name)
    rows = []
    active = [0, 1, 3]
    for heads, (s, kv_len) in ((h, c) for h in layouts for c in cases):
        kvh, grp, hd = heads
        args = _attn_case(dev, s, kv_len, seed=s, heads=heads)
        kp_ref, vp_ref, out_ref = ops.paged_attention(
            *args, kv_len=kv_len, backend="torch")
        out_nudged = ops.paged_attention(*_v_nudged(args), kv_len=kv_len,
                                         backend="torch")[2]
        kp, vp = args[3].clone(), args[4].clone()
        kargs = args[:3] + (kp, vp) + args[5:]
        _, _, out = ops.paged_attention(*kargs, kv_len=kv_len,
                                        backend="cuda")
        torch.cuda.synchronize()
        pools_equal = torch.equal(kp, kp_ref) and torch.equal(vp, vp_ref)
        o, r = out[active].float(), out_ref[active].float()
        err = (o - r).abs().max().item()
        tol = (out_nudged[active].float() - r).abs().max().item()
        close = (torch.allclose(o, r, atol=ATTN_ATOL, rtol=ATTN_RTOL)
                 and 0 < tol and err <= tol)
        finite = bool(torch.isfinite(out[active].float()).all())
        label = (f"paged_attention B=4 S={s} KV={kvh} G={grp} hd={hd} bs=16 "
                 f"T={kv_len}")
        if not (pools_equal and close and finite):
            raise AssertionError(
                f"{label}: pools equal={pools_equal}, max|diff|={err} (atol "
                f"{ATTN_ATOL}, rtol {ATTN_RTOL}, one-ulp V bound {tol}), "
                f"finite={finite}")
        if not deterministic(lambda: ops.paged_attention(
                *kargs, kv_len=kv_len, backend="cuda")[2][active]):
            raise AssertionError(f"{label} differs between two calls")
        plan = ops.attention_plan(s, grp, hd, kv_len,
                                  registry.device_props(dev.index))
        # timings: pools rotated past the L2 cache like the weights
        nbytes = 2 * args[3].numel() * args[3].element_size()
        rot = Rotating(lambda: (args[3].clone(), args[4].clone()), nbytes)

        def kern():
            k_p, v_p = rot.next()
            return ops.paged_attention(*args[:3], k_p, v_p, *args[5:],
                                       kv_len=kv_len, backend="cuda")

        def plain():
            k_p, v_p = rot.next()
            return ops.paged_attention(*args[:3], k_p, v_p, *args[5:],
                                       kv_len=kv_len, backend="torch")

        t = device_ms(kern)
        p = device_ms(plain, iters=5)
        q = args[0]
        b = q.shape[0]
        qh = q.reshape(b, s, kvh * grp, hd).transpose(1, 2)
        kg = ref.gather_rows(kp_ref, args[5], kv_len).transpose(1, 2)
        vg = ref.gather_rows(vp_ref, args[5], kv_len).transpose(1, 2)
        mask = ref.causal_mask(args[7], s, kg.shape[2])[:, None]
        lib = device_ms(lambda: F.scaled_dot_product_attention(
            qh, kg, vg, attn_mask=mask, enable_gqa=grp > 1))
        bound = _attn_bound(args, kv_len, bw, flops)
        log(f"{label} (window over {plan.splits} CTAs): max|diff|={err:.3g} "
            f"(one-ulp V bound {tol:.3g}, max|out| "
            f"{r.abs().max().item():.3g}) pools bit-equal (trash block "
            f"included), two calls bit-equal | "
            f"kernel {t:.4f} ms (plain {p:.4f}, bound {bound:.4f}, "
            f"{share(bound, t)} of bound) | sdpa {lib:.4f} ms, kernel / "
            f"sdpa {t / lib:.3f}")
        rows.append(dict(S=s, T=kv_len, KV=kvh, G=grp, hd=hd,
                         max_abs_err=err, ms=t, plain_ms=p, bound_ms=bound,
                         bound_by="bytes", library_ms=lib))
    return rows


def attention_row(rows: list[dict]) -> dict:
    """K3's row of the kernels line: the first case (decode, T = 81)."""
    return {k: v for k, v in rows[0].items()
            if k not in ("S", "T", "KV", "G", "hd")}


def check_trash_store(dev) -> None:
    """K3's store where rows collide: 8 rows, 6 of them inactive (all-
    trash tables) at depths that send them to the same trash cells, and
    one writing past its table width, at a decode step (S = 1) and a
    chunk (S = 16); the pools after the kernel equal the plain
    version's bit for bit, trash block included (the last row wins a
    cell on both), in two calls from the same pools."""
    import torch
    from repro_torch.kernels.paged_attention import ops
    b, kvh, grp, hd, bs, w = 8, 16, 1, 128, 16, 6
    g = torch.Generator(device=dev).manual_seed(11)
    for s in (1, 16):
        def rnd(*shape):
            return torch.randn(shape, generator=g, device=dev).to(
                torch.bfloat16)

        nb = 1 + 2 * w
        q = rnd(b, s, kvh, grp, hd)
        k_new, v_new = rnd(b, s, kvh, hd), rnd(b, s, kvh, hd)
        k_pool, v_pool = rnd(nb, bs, kvh, hd), rnd(nb, bs, kvh, hd)
        table = torch.zeros((b, w), dtype=torch.int32, device=dev)
        table[0] = torch.arange(1, w + 1)
        table[5] = torch.arange(w + 1, 2 * w + 1)
        # rows 1-4, 6 and 7 inactive, all at offset 3 of the trash block;
        # row 5 past its width from its fourth position on (S = 16)
        ci = torch.tensor([40, 3, 19, 35, 51, w * bs - 3 if s > 1 else 20,
                           67, 83], dtype=torch.int32, device=dev)
        args = (q, k_new, v_new, k_pool, v_pool, table, table.clone(), ci)
        kp_ref, vp_ref, _ = ops.paged_attention(*args, kv_len=w * bs,
                                                backend="torch")
        got = []
        for _ in range(2):
            kp, vp = k_pool.clone(), v_pool.clone()
            ops.paged_attention(*args[:3], kp, vp, *args[5:],
                                kv_len=w * bs, backend="cuda")
            got.append((kp, vp))
        torch.cuda.synchronize()
        equal = all(torch.equal(kp, kp_ref) and torch.equal(vp, vp_ref)
                    for kp, vp in got)
        last = torch.equal(kp_ref[0, 3], k_new[7, 0])
        log(f"paged_attention store, {b} rows, 6 inactive on one trash cell "
            f"(S={s}{', one row past its width' if s > 1 else ''}): pools "
            f"bit-equal to the plain version in two calls: {equal}; the "
            f"last row's value in the shared cell: {last}")
        if not (equal and last):
            raise AssertionError(f"K3's duplicate-trash store at S={s}")


# the prefix cache's write table: a chunk of 16 at Qwen2.5-3B's layout
# (T = 81), rows 0-3 with 3, 1, 1 and 2 leading table columns shared;
# rows 0 and 3 store across a shared and a private column
SHARED_COLS = [3, 1, 1, 2]
SHARED_CI = [40, 64, 0, 20]


def check_shared_cols(dev) -> None:
    """K3 storing through a write table whose leading shared columns are
    sent to the trash block (``kv_pool.mask_shared_cols``) and reading
    through the real table: its pools bit-equal to the plain version's
    (trash block included), every block in a shared column unchanged bit
    for bit, the outputs within the stated tolerance and the one-ulp V
    bound, two calls bit-equal."""
    import torch
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.serve import kv_pool
    t0 = time.perf_counter()
    s, kv_len = 16, 81
    q, k_new, v_new, k_pool, v_pool, table, _, _ = _attn_case(
        dev, s, kv_len, seed=21)
    ci = torch.tensor(SHARED_CI, dtype=torch.int32, device=dev)
    shared = torch.tensor(SHARED_COLS, dtype=torch.int32, device=dev)
    write = kv_pool.mask_shared_cols(table, shared)
    args = (q, k_new, v_new, k_pool, v_pool, table, write, ci)
    kp_ref, vp_ref, out_ref = ops.paged_attention(*args, kv_len=kv_len,
                                                  backend="torch")
    out_nudged = ops.paged_attention(*_v_nudged(args), kv_len=kv_len,
                                     backend="torch")[2]
    runs = []
    for _ in range(2):
        kp, vp = k_pool.clone(), v_pool.clone()
        out = ops.paged_attention(*args[:3], kp, vp, *args[5:],
                                  kv_len=kv_len, backend="cuda")[2]
        runs.append((kp, vp, out))
    torch.cuda.synchronize()
    kp, vp, out = runs[0]
    equal = all(torch.equal(a, kp_ref) and torch.equal(b, vp_ref)
                for a, b, _ in runs)
    same = torch.equal(runs[0][2], runs[1][2])
    active = [0, 1, 3]
    blocks = sorted({int(table[r, c]) for r in active
                     for c in range(SHARED_COLS[r])})
    kept = all(torch.equal(p[blocks], orig[blocks])
               for p, orig in ((kp, k_pool), (vp, v_pool)))
    # rows 0 and 3 store past their shared columns too: the pools moved
    stored = not torch.equal(kp[1:], k_pool[1:])
    o, r = out[active].float(), out_ref[active].float()
    err = (o - r).abs().max().item()
    tol = (out_nudged[active].float() - r).abs().max().item()
    close = (torch.allclose(o, r, atol=ATTN_ATOL, rtol=ATTN_RTOL)
             and 0 < tol and err <= tol)
    log(f"paged_attention B=4 S={s} T={kv_len}, shared columns "
        f"{SHARED_COLS} at cache indices {SHARED_CI}: pools bit-equal to "
        f"the plain version's in two calls (trash block included): "
        f"{equal}; the {len(blocks)} blocks of shared columns unchanged "
        f"bit for bit: {kept}; private columns stored: {stored}; "
        f"max|diff|={err:.3g} (one-ulp V bound {tol:.3g}); two calls "
        f"bit-equal: {same}; {time.perf_counter() - t0:.1f} s")
    if not (equal and kept and stored and close and same):
        raise AssertionError("K3 through the prefix cache's write table")


GF2_SHAPES = [(128, 128), (200, 129), (64, 32), (48, 16), (512, 48),
              (1000, 129)]
GF2_ROWS = [1, 7, 130, 4096]
AES_BLOCKS = 1 << 24
GF2_PLAIN_CHUNK = 1 << 22        # rows per plain call in the big check


def _gf2_max_err(got, want) -> int:
    import torch
    return int((got.to(torch.int32) - want.to(torch.int32)).abs().max())


def _gf2_big_err(fn, plain, *inputs) -> int:
    """max |kernel - plain| of ``fn`` on full-size inputs, the plain
    version taken GF2_PLAIN_CHUNK rows at a time."""
    got = fn(*inputs)
    return max(_gf2_max_err(got[r0:r0 + GF2_PLAIN_CHUNK],
                            plain(inputs[0][r0:r0 + GF2_PLAIN_CHUNK],
                                  *inputs[1:]))
               for r0 in range(0, inputs[0].shape[0], GF2_PLAIN_CHUNK))


def check_gf2(dev, gpu_name: str) -> dict[str, dict]:
    """K4's two entries bit for bit against their plain versions at the
    card tests' shapes and at the AES shape (2^24 blocks, the cipher's
    ShiftRows∘MixColumns matrix), two calls bit-equal, and timed there
    beside their bounds, the plain versions and ``torch._int_mm`` +
    ``& 1`` (for the state-byte entry on the unpacked bits: no one
    PyTorch call computes it)."""
    import torch
    from repro_torch.apps import aes_app
    from repro_torch.kernels.gf2_mvm import ops, ref
    bw, _, int8_rate = peaks(gpu_name)
    g = torch.Generator(device=dev).manual_seed(4)
    mats = [torch.as_tensor(m, dtype=torch.int8, device=dev)
            for m in aes_app._linear_matrices()]

    def mvm(x, a):
        return ops.gf2_mvm(x, a, backend="cuda")

    def packed(s, a):
        return ops.gf2_mvm_packed(s, a, backend="cuda")

    def plain(x, a):
        return ops.gf2_mvm(x, a, backend="torch")

    def plain_packed(s, a):
        return ops.gf2_mvm_packed(s, a, backend="torch")

    for k, n in GF2_SHAPES:
        a = torch.randint(0, 2, (k, n), generator=g, device=dev,
                          dtype=torch.int8)
        for m in GF2_ROWS:
            x = torch.randint(-128, 128, (m, k), generator=g, device=dev,
                              dtype=torch.int8)
            if _gf2_max_err(mvm(x, a), plain(x, a)):
                raise AssertionError(f"gf2_mvm not bit-exact at M={m} "
                                     f"K={k} N={n}")
    # the state-byte entry: the three AES matrices and one of any int8
    # values (only each entry's low bit counts)
    any_a = torch.randint(-128, 128, (128, 128), generator=g, device=dev,
                          dtype=torch.int8)
    for a in mats + [any_a]:
        for m in GF2_ROWS:
            s = torch.randint(0, 256, (m, 16), generator=g, device=dev,
                              dtype=torch.uint8)
            if _gf2_max_err(packed(s, a), plain_packed(s, a)):
                raise AssertionError(f"gf2_mvm_packed not bit-exact at "
                                     f"M={m}")

    m, k, n = AES_BLOCKS, 128, 128
    a = mats[0]
    x = torch.randint(0, 2, (m, k), generator=g, device=dev,
                      dtype=torch.int8)
    err = _gf2_big_err(mvm, plain, x, a)
    if err or not deterministic(lambda: mvm(x, a)):
        raise AssertionError(f"gf2_mvm at the AES shape M={m}: max|diff| "
                             f"{err}, or two calls differ")
    t = event_ms(lambda: mvm(x, a))
    p = event_ms(lambda: plain(x, a), reps=2)
    acc = torch._int_mm(x, a)
    mm = event_ms(lambda: torch._int_mm(x, a))
    epi = event_ms(lambda: acc & 1)
    del acc
    bound = max((m * k + k * n + m * n) / bw, 2 * m * k * n / int8_rate) * 1e3
    log(f"gf2_mvm bit-exact at M in {GF2_ROWS} x (K, N) in {GF2_SHAPES} and "
        f"at M={m} K={k} N={n}, two calls bit-equal | kernel {t:.4f} ms "
        f"(plain {p:.4f}, bound {bound:.4f}, {share(bound, t)} of bound) | "
        f"_int_mm {mm:.4f} ms + & 1 {epi:.4f} ms")
    rows = {"gf2_mvm": dict(max_abs_err=err, ms=t, plain_ms=p,
                            bound_ms=bound, bound_by="bytes",
                            library_ms=mm + epi)}
    del x

    s = torch.randint(0, 256, (m, 16), generator=g, device=dev,
                      dtype=torch.uint8)
    err = _gf2_big_err(packed, plain_packed, s, a)
    if err or not deterministic(lambda: packed(s, a)):
        raise AssertionError(f"gf2_mvm_packed at M={m}: max|diff| {err}, "
                             f"or two calls differ")
    t = event_ms(lambda: packed(s, a))
    p = event_ms(lambda: plain_packed(s, a), reps=2)
    bits = ref.unpack_bits(s)
    mm = event_ms(lambda: torch._int_mm(bits, a) & 1)
    del bits
    bound = (2 * m * 16 + k * n) / bw * 1e3
    log(f"gf2_mvm_packed bit-exact at M in {GF2_ROWS} x the 3 AES matrices "
        f"and an int8 one, and at M={m}, two calls bit-equal | kernel "
        f"{t:.4f} ms (plain {p:.4f}, bound {bound:.4f}, {share(bound, t)} "
        f"of bound) | _int_mm + & 1 on the unpacked bits {mm:.4f} ms")
    rows["gf2_mvm_packed"] = dict(max_abs_err=err, ms=t, plain_ms=p,
                                  bound_ms=bound, bound_by="bytes",
                                  library_ms=None)
    return rows


# ---------------------------------------------------------------------------
# Phases 4-5b: serving the full-width model
# ---------------------------------------------------------------------------

SERVE_ARGS = ["--arch", "qwen2.5-3b", "--batch-slots", "4", "--requests",
              "6", "--min-prompt-len", "20", "--prompt-len", "64", "--gen",
              "16", "--kv-block-size", "16", "--chunked-prefill", "--seed",
              "0", "--device", "cuda"]
SERVE_MODES = ("pum", "int8", "bf16")
# the MVM kernel of each mode; bf16's projections are float matmuls
MVM_OF_MODE = {"pum": "bitslice_mvm_scaled", "int8": "bitslice_mvm",
               "bf16": None}


# MVM launches of each mixer kind in a forward pass: q, k, v and o of
# attention, the in, x, dt and out projections of Mamba, the five of an
# mLSTM (qkv, i, f, output gate, out) or sLSTM (z, i, f, o, out) layer
MIXER_MVM = {"attn": 4, "mamba": 4, "mlstm": 5, "slstm": 5}


def per_pass(cfg) -> tuple[int, int]:
    """(MVM launches, attention layers) of one forward pass: the mixer's
    (``MIXER_MVM``) and the MLP's (gate, up, down when gated; an MoE
    FFN's router and experts are float products): 7 a Qwen2.5-3B layer,
    5 an xLSTM-350M one (it has no MLP), 44 a period of Jamba-v0.1."""
    from repro_torch.models import transformer
    kinds = [transformer.layer_kinds(cfg, j) for j in range(cfg.num_layers)]
    mlp = 3 if cfg.activation == "silu" else 2
    attn = sum(mk == "attn" for mk, _ in kinds)
    mvm = sum(MIXER_MVM[mk] + mlp * (fk == "mlp") for mk, fk in kinds)
    return mvm, attn


def launch_gate(mode: str, cfg, steps: int, chunks: int,
                launches: dict, paged: bool = True) -> dict:
    """Every decode step and prefill chunk: the projections of every
    layer (``per_pass``) on the mode's MVM kernel and none on the other,
    and one K3 call an attention layer over the paged pool, none over
    contiguous windows."""
    mvm, attn = per_pass(cfg)
    want = {"bitslice_mvm_scaled": 0, "bitslice_mvm": 0,
            "paged_attention": attn * (steps + chunks) if paged else 0}
    if MVM_OF_MODE[mode]:
        want[MVM_OF_MODE[mode]] = mvm * (steps + chunks)
    got = {k: launches.get(k, 0) for k in want}
    if got != want:
        raise AssertionError(f"{mode}: launches {got}, expected {want} for "
                             f"{steps} decode steps + {chunks} chunks")
    return got


def tokens_of(completions: dict) -> dict[int, list[int]]:
    return {rid: c.tokens for rid, c in sorted(completions.items())}


def timed_run(sched, requests) -> dict:
    """``sched.run(requests)``, with the launches, decode steps, chunks,
    decode ms/step, prefill seconds, wall and graph-build seconds,
    tokens/s and peak memory of exactly that run."""
    import torch
    from repro_torch.kernels import registry
    steps, chunks = sched.decode_steps, sched.prefill_chunks
    secs, pre = sched.decode_seconds, sched.prefill_seconds
    built = sched.graphs_captured()[1]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    registry.reset_launches()
    t0 = time.perf_counter()
    comps = sched.run(requests)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = sched.decode_steps - steps
    return dict(tokens=tokens_of(comps), launches=dict(registry.LAUNCHES),
                steps=n, chunks=sched.prefill_chunks - chunks,
                decode_ms=1e3 * (sched.decode_seconds - secs) / max(1, n),
                prefill_s=sched.prefill_seconds - pre, wall_s=wall,
                build_s=sched.graphs_captured()[1] - built,
                tokens_per_s=sum(len(c.tokens) for c in comps.values())
                / wall, peak_gb=torch.cuda.max_memory_allocated() / 1e9)


def serve_run(mode: str, smi: str) -> tuple[dict, dict]:
    """The main path: one run of the port's CLI, whose scheduler builds
    one CUDA graph for decode and one per chunk length as it goes.
    Returns the CLI's result and the launch counts of exactly that run
    (replays counted)."""
    import torch
    from repro_torch.kernels import registry
    from repro_torch.launch import serve
    torch.cuda.reset_peak_memory_stats()
    registry.reset_launches()
    res = serve.main(SERVE_ARGS + ["--pum-mode", mode])
    torch.cuda.synchronize()
    launches = dict(registry.LAUNCHES)
    sched = res["scheduler"]
    cfg = sched.cfg
    comps = res["completions"]
    vp = sched.params["embed"].shape[0]
    if len(comps) != 6 or any(
            len(c.tokens) != 16 or c.finish_reason != "length"
            or not all(0 <= t < vp for t in c.tokens)
            for c in comps.values()):
        raise AssertionError(f"{mode}: completions "
                             f"{[(c.rid, c.tokens) for c in comps.values()]}")
    steps, chunks = sched.decode_steps, sched.prefill_chunks
    got = launch_gate(mode, cfg, steps, chunks, launches)
    progs = sched.step_programs()
    built = [progs["decode"], *progs["chunk"].values()]
    if any(n != 1 for n in built) or res["graphs"] != len(built):
        raise AssertionError(f"{mode}: programs {progs}, {res['graphs']} "
                             f"graphs; want each built once, as a graph")
    log(f"serve {mode}: {cfg.name} {cfg.num_layers} layers d_model "
        f"{cfg.d_model}, 6 requests x 16 tokens, {steps} decode steps, "
        f"{chunks} prefill chunks; launches {got} (replays counted); "
        f"programs {progs}")
    log(f"serve {mode} graphs (first run, builds included): "
        f"decode_ms_per_step={res['decode_ms']:.3f} tokens_per_s="
        f"{res['tokens'] / res['wall_s']:.2f} graphs_captured="
        f"{res['graphs']} capture_s={res['build_s']:.2f} (warm-up "
        f"included) peak_mem_GB="
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} on {smi}")
    return res, launches


def chunk_and_step(sched, params, backend: str, toks=None):
    """One prefill chunk and one decode step of ``sched``'s model on
    ``params``, from a fresh pool, on ``backend``: their last logits
    [1, 2, V] in f32."""
    import torch
    from repro_torch.kernels import registry
    from repro_torch.models import lm
    cfg, dev = sched.cfg, sched.device
    bs, max_len = sched.block_size, sched.max_len
    w = sched.table_width
    if toks is None:
        g = torch.Generator(device="cpu").manual_seed(1)
        toks = torch.randint(0, cfg.vocab_size, (1, bs + 1), generator=g)
    toks = toks.to(dev, torch.int32)
    table = torch.arange(1, w + 1, dtype=torch.int32, device=dev)[None]
    states = lm.init_paged_state(cfg, 1, max_len, num_blocks=w,
                                 block_size=bs, device=dev)
    with torch.inference_mode(), registry.use_backend(backend):
        chunk, states = lm.forward(
            params, toks[:, :bs], cfg, states=states,
            cache_index=torch.zeros(1, dtype=torch.int32, device=dev),
            block_table=table, kv_len=max_len, last_only=True)
        step, states = lm.forward(
            params, toks[:, bs:], cfg, states=states,
            cache_index=torch.full((1,), bs, dtype=torch.int32, device=dev),
            block_table=table, kv_len=max_len, last_only=True)
    return torch.cat([chunk, step], dim=1).float()


def nudged(params):
    """``params`` with layer 0's attention input moved by one bf16 ulp
    on every other channel (its norm scale times 1 + ULP)."""
    import torch
    norm = dict(params["blocks"][0]["norm1"])
    nudge = torch.ones_like(norm["scale"])
    nudge[::2] += ULP
    norm["scale"] = norm["scale"] * nudge
    return dict(params, blocks=[dict(params["blocks"][0], norm1=norm),
                                *params["blocks"][1:]])


def backend_parity(sched, near_ties: bool = False) -> None:
    """One prefill chunk and one decode step of the served model, from
    the same fresh pool, on the ``cuda`` and the ``torch`` backends, and
    on ``cuda`` once more with layer 0's attention input moved by one
    bf16 ulp on every other channel: that run's change is the bound.
    The greedy token must be the same on every row; with ``near_ties``,
    on every row but those whose torch top-2 margin is within twice the
    two backends' difference, the rows that difference can flip
    (counted and printed)."""
    import torch
    cfg, params = sched.cfg, sched.params
    a = chunk_and_step(sched, params, "cuda")
    b = chunk_and_step(sched, params, "torch")
    c = chunk_and_step(sched, nudged(params), "cuda")
    if not all(bool(torch.isfinite(t).all()) for t in (a, b, c)):
        raise AssertionError("non-finite logits")
    err = (a - b).abs().max().item()
    bound = (c - a).abs().max().item()
    differ = (a.argmax(-1) != b.argmax(-1)).flatten()
    top2 = torch.topk(b, 2, dim=-1).values.flatten(0, -2)
    margins = top2[:, 0] - top2[:, 1]
    ties = margins <= 2 * err
    same = not bool((differ & ~ties).any()) if near_ties \
        else not bool(differ.any())
    log(f"backend parity {cfg.pum.mode}: chunk + decode logits "
        f"max|cuda - torch| = {err:.4g}, bound (one-ulp nudge of layer 0) "
        f"= {bound:.4g}, max|logit| = {b.abs().max().item():.4g}, greedy "
        f"tokens equal on {int((~differ).sum())} of {differ.numel()} rows "
        f"(torch top-2 margins {[round(m, 4) for m in margins.tolist()]}; "
        f"{int(ties.sum())} within 2 x max|cuda - torch|)")
    if bound == 0.0:
        raise AssertionError("the one-ulp nudge did not reach the logits")
    if err > bound or not same:
        raise AssertionError(f"backend parity failed: {err} > {bound} or "
                             f"greedy differs")


# the prefix cache's trace (phases 4, 5, 10 and 12): 4 slots, KV blocks
# of 16, chunked prefill, one 48-token prefix drawn from the seed; six
# greedy requests of 16 tokens: the whole prefix, prefix[:40],
# prefix[:20], the prefix and 8 tokens, the prefix and 16 tokens (a
# burst), the whole prefix again at step 8
PREFIX_LEN = 48
PREFIX_TAILS = [(48, 0), (40, 0), (20, 0), (48, 8), (48, 16), (48, 0)]
PREFIX_ARRIVALS = [0, 0, 0, 0, 0, 8]
PREFIX_GEOMETRY = dict(num_slots=4, max_len=81, kv_block_size=16,
                       chunked_prefill=True)
# what the trace implies, (hits, tokens skipped, blocks shared), summed
# over the cold run and then over the cold and the warm run.  Requests
# 0-3 take the 4 slots at step 0: nothing is cached, and by step 2 their
# prefills have cached the prefix's blocks h0 (request 2's), h1 and h2
# (request 0's).  Requests 4 and 5 wait for slots (FIFO).  A dense
# stack: request 4 (64 tokens) attaches h0-h2 and skips 48 tokens;
# request 5 (48, all cached) attaches 3 and copies the last on write,
# skipping 47: cold (2, 95, 6), request 4 having cached h3.  Warm, all
# hit: 47 + 32 + 16 + 48 + 63 + 47 tokens over 3 + 2 + 1 + 3 + 4 + 3
# blocks.  A recurrent stack resumes only at a snapshot before its last
# prompt token, at most (plen - 1) // 16 blocks in: cold 48 + 32
# tokens, warm 32 + 32 + 16 + 48 + 48 + 32; xLSTM shares no block,
# Jamba attaches the matched ones (cold 3 + 2, warm 2 + 2 + 1 + 3 + 3
# + 2).
PREFIX_STATS = {"dense": [(2, 95, 6), (8, 348, 22)],
                "xlstm": [(2, 80, 0), (8, 288, 0)],
                "hybrid": [(2, 80, 5), (8, 288, 18)]}


def prefix_trace(vocab: int, seed: int = 0) -> list:
    import numpy as np
    from repro_torch.serve import Request
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, size=PREFIX_LEN).tolist()
    return [Request(prefix[:n] + rng.integers(0, vocab, size=t).tolist(),
                    max_tokens=16, arrival=a, rid=i)
            for i, ((n, t), a) in enumerate(zip(PREFIX_TAILS,
                                                PREFIX_ARRIVALS))]


def prefix_check(label: str, family: str, cfg, params, smi: str
                 ) -> dict[str, int]:
    """The prefix cache on ``cfg`` served at full width on the card:
    the trace (``prefix_trace``) on a scheduler with the cache twice,
    cold then warm, and once on one without.  Gated: every completion of
    both cached runs equals the uncached run's bit for bit; the
    counters equal what the trace implies (``PREFIX_STATS``: a recurrent
    stack's figures admit no match past ``(plen - 1) // 16`` blocks);
    the MVM and K3
    launch counts of each run on its own steps and chunks; each step
    built once, as a graph, and the warm run builds nothing; after
    ``drain()`` and ``flush_prefix_cache()`` no block is live.  Prints
    prefill chunks, prefill seconds (host time of the chunk replays) and
    tokens/s of the three runs, the latter also without the seconds the
    run spent building graphs (the uncached and the cold run build their
    schedulers' steps).
    Returns the cold run's launches (the path's first run)."""
    import gc
    import torch
    from repro_torch.serve import ContinuousBatchingScheduler
    t0 = time.perf_counter()
    dev = params["embed"].device
    reqs = prefix_trace(cfg.vocab_size)
    on = ContinuousBatchingScheduler(cfg, params, prefix_cache=True,
                                     device=dev, **PREFIX_GEOMETRY)
    off = ContinuousBatchingScheduler(cfg, params, device=dev,
                                      **PREFIX_GEOMETRY)
    runs = {"off": timed_run(off, reqs), "cold": timed_run(on, reqs)}
    stats = [on.prefix_stats()]
    progs, graphs = on.step_programs(), on.graphs_captured()[0]
    runs["warm"] = timed_run(on, reqs)
    stats.append(on.prefix_stats())
    mode = cfg.pum.mode
    for run in runs.values():
        launch_gate(mode, cfg, run["steps"], run["chunks"], run["launches"])
    built = [progs["decode"], *progs["chunk"].values()]
    snaps = (on._prefix.snapshots, on._prefix.snapshot_bytes,
             on._prefix.max_snapshots)
    got = [tuple(st[k] for k in ("hits", "tokens_skipped", "blocks_shared"))
           for st in stats]
    on.drain()
    on.flush_prefix_cache()
    gates = {
        "cold and warm completions equal the uncached run's":
            runs["cold"]["tokens"] == runs["warm"]["tokens"]
            == runs["off"]["tokens"],
        "hits, tokens skipped and blocks shared as the trace implies":
            got == PREFIX_STATS[family],
        "each step built once, as a graph; the warm run builds nothing":
            all(n == 1 for n in built) and graphs == len(built)
            and on.step_programs() == progs,
        "no block live after drain and flush":
            on._alloc.live_blocks == 0 and on.prefix_cached_blocks == 0,
    }
    failed = [k for k, ok in gates.items() if not ok]
    steady = {k: r["tokens_per_s"] * r["wall_s"] / (r["wall_s"]
                                                     - r["build_s"])
              for k, r in runs.items()}
    log(f"prefix cache {label} {mode}: counters cold / cold + warm {got} "
        f"(want {PREFIX_STATS[family]}); programs {progs}; " + "; ".join(
            f"{k} {r['chunks']} prefill chunks in {r['prefill_s']:.3f} s, "
            f"{r['steps']} decode steps, {r['tokens_per_s']:.2f} tokens/s "
            f"({steady[k]:.2f} without {r['build_s']:.2f} s of graph "
            f"builds)"
            for k, r in runs.items())
        + f"; {snaps[0]} snapshots held, {snaps[1] / 1e6:.1f} MB (at most "
        f"{snaps[2]}); check {time.perf_counter() - t0:.1f} s; gates failed: "
        f"{failed} on {smi}")
    if failed:
        raise AssertionError(f"prefix cache {label} {mode}: {failed}")
    del on, off
    gc.collect()
    torch.cuda.empty_cache()
    return runs["cold"]["launches"]


def long_snapshots(cfg, params, smi: str) -> dict[str, int]:
    """The recurrent snapshots of one long prompt: ``long_request``'s
    LONG_PROMPT tokens on a paged, chunked scheduler of LONG_MAX_LEN
    positions with the prefix cache, served twice.  The cold run
    snapshots the slot's rows at each of its LONG_PROMPT / 16 block
    edges (within ``scheduler.snapshot_budget``: half the card's memory
    free when the scheduler is built); the warm run resumes at the
    deepest edge before the last prompt token and feeds one chunk.
    Gated: the warm tokens equal the cold ones, LONG_PROMPT - 16 tokens
    skipped, the snapshots within their bound, the MVM launch counts of
    each run, no entry left after a flush.  Prints the snapshots' count
    and bytes beside the bound and both runs' prefill seconds.  Returns
    the cold run's launches."""
    import gc
    import torch
    from repro_torch.serve import ContinuousBatchingScheduler
    t0 = time.perf_counter()
    sched = ContinuousBatchingScheduler(
        cfg, params, num_slots=PREFIX_GEOMETRY["num_slots"],
        max_len=LONG_MAX_LEN, kv_block_size=16, chunked_prefill=True,
        prefix_cache=True, device=params["embed"].device)
    req = long_request(cfg.vocab_size)
    cold = timed_run(sched, [req])
    held = (sched._prefix.snapshots, sched._prefix.snapshot_bytes,
            sched._prefix.max_snapshots)
    warm = timed_run(sched, [req])
    stats = sched.prefix_stats()
    for run in (cold, warm):
        launch_gate(cfg.pum.mode, cfg, run["steps"], run["chunks"],
                    run["launches"], paged=False)
    sched.drain()
    sched.flush_prefix_cache()
    gates = {
        "the warm run gives the cold run's tokens":
            warm["tokens"] == cold["tokens"],
        "the warm run resumes at the deepest edge before the last token":
            (stats["hits"], stats["tokens_skipped"], warm["chunks"])
            == (1, LONG_PROMPT - 16, 1),
        "the snapshots within their bound":
            held[2] is None or held[0] <= held[2],
        "no entry left after a flush": sched.prefix_stats()["entries"] == 0,
    }
    failed = [k for k, ok in gates.items() if not ok]
    log(f"prefix cache {cfg.name} {cfg.pum.mode} long prompt: "
        f"{LONG_PROMPT} tokens, {held[0]} snapshots held after the cold "
        f"run, {held[1] / 1e9:.3f} GB ({held[1] / max(1, held[0]) / 1e6:.2f}"
        f" MB each; at most {held[2]} within the budget); prefill cold "
        f"{cold['chunks']} chunks in {cold['prefill_s']:.3f} s, warm "
        f"{warm['chunks']} chunk in {warm['prefill_s']:.3f} s; check "
        f"{time.perf_counter() - t0:.1f} s; gates failed: {failed} on {smi}")
    if failed:
        raise AssertionError(f"long-prompt snapshots: {failed}")
    del sched
    gc.collect()
    torch.cuda.empty_cache()
    return cold["launches"]


def kernel_times(run):
    """``run()`` under ``torch.profiler``: (wall s, device us by kernel
    name).  The profiler slows the host, so its wall time is not an
    unprofiled run's; the kernel times are the card's."""
    import collections
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: collections.Counter[str] = collections.Counter()
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            by_name[evt.name] += evt.time_range.elapsed_us()
    return wall, by_name


def top_kernels(by_name, n: int = 6) -> str:
    return ", ".join(
        f"{name.replace('void ', '').replace('(anonymous namespace)::', '')[:40]}"
        f" {us / 1e3:.1f} ms" for name, us in by_name.most_common(n))


def profiled(run) -> tuple[float, float, str] | None:
    """``run()`` under ``torch.profiler``: (wall s, s the card spent in
    kernels, the top kernels by time), or None when the profiler saw no
    device time."""
    wall, by_name = kernel_times(run)
    if not by_name:
        return None
    return wall, sum(by_name.values()) / 1e6, top_kernels(by_name)


def like(sched, cuda_graphs: bool = True, kernel_backend=None, **kw):
    """A fresh scheduler of ``sched``'s geometry on its params (``kw``:
    more constructor arguments, such as ``speculate_k``)."""
    from repro_torch.serve import ContinuousBatchingScheduler
    return ContinuousBatchingScheduler(
        sched.cfg, sched.params, num_slots=sched.num_slots,
        max_len=sched.max_len, kv_block_size=sched.block_size,
        num_kv_blocks=sched.num_kv_blocks,
        chunked_prefill=sched.chunked_prefill, device=sched.device,
        cuda_graphs=cuda_graphs, kernel_backend=kernel_backend, **kw)


def graph_vs_eager(sched) -> None:
    """One prefill chunk and one decode step of the served model, each
    from a fresh pool, with ``cuda_graphs`` on and off: the same kernels
    on the same inputs, so the logits must be equal bit for bit (the
    chunk's, and the decoding row's of the step) and so the tokens."""
    import torch
    from repro_torch.serve import Request
    bs = sched.block_size
    g = torch.Generator().manual_seed(2)
    prompt = torch.randint(0, sched.cfg.vocab_size, (bs,),
                           generator=g).tolist()
    got = {}
    for graphs in (True, False):
        s = like(sched, graphs)
        s.start_request(Request(prompt, max_tokens=2, rid=0))
        res = s.tick(0)              # the prompt's one chunk, then a step
        logits = s.last_logits()
        got[graphs] = ([t for _, _, t in res.events], logits[bs].clone(),
                       logits["decode"][0].clone())
        del s
    (tok_g, chunk_g, step_g), (tok_e, chunk_e, step_e) = got[True], got[False]
    equal = torch.equal(chunk_g, chunk_e) and torch.equal(step_g, step_e)
    err = max((chunk_g - chunk_e).abs().max().item(),
              (step_g - step_e).abs().max().item())
    log(f"graph vs eager {sched.cfg.pum.mode}: chunk of {bs} + one decode "
        f"step logits bit-equal: {equal} (max|diff| {err:.3g}), tokens "
        f"{tok_g} / {tok_e}")
    if not equal or tok_g != tok_e or len(tok_g) != 2:
        raise AssertionError("graph and eager steps differ")


def step_device_ms(sched, temps=None) -> float:
    """Device time of one replay of the decode graph, between CUDA
    events, every slot active at a depth of 60 tokens (the trace's
    middle) through its own blocks or in its own window (the scheduler
    is idle after the run), at temperatures ``temps`` (default: all
    greedy; the graph runs the sampler either way)."""
    import numpy as np
    prog = sched.program("decode")
    b, w = sched.num_slots, sched.table_width
    # paged: each slot's own blocks, none shared
    table = [np.arange(1, b * w + 1, dtype=np.int32).reshape(b, w),
             np.zeros(b, np.int32)] if sched.paged else []
    ones = np.ones(b, np.int32)
    temps = np.zeros(b, np.float32) if temps is None \
        else np.asarray(temps, np.float32)
    keys = np.stack([np.zeros(b, np.int32), np.arange(b, dtype=np.int32)],
                    axis=1)
    prog.stage(np.zeros((b, 1), np.int32), 60 * ones, keys, ones,
               temps.view(np.int32), -ones, ones, (1 << 20) * ones, *table)
    return event_ms(prog.launch, reps=20)


def head_share(sched, step_ms: float, smi: str) -> None:
    """The f32 lm head alone (``lm.forward``'s last matmul) at the
    decode step's B, timed with CUDA events, as a share of the step."""
    import torch
    cfg, params, dev = sched.cfg, sched.params, sched.device
    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    g = torch.Generator(device=dev).manual_seed(3)
    h = torch.randn((sched.num_slots, 1, cfg.d_model), generator=g,
                    device=dev)
    ms = device_ms(lambda: torch.matmul(h, head.to(torch.float32)))
    log(f"lm head {cfg.pum.mode}: f32 [{sched.num_slots}, {cfg.d_model}] x "
        f"{list(head.shape)} {ms:.4f} ms = {100 * ms / step_ms:.1f} % of one "
        f"decode step's device time {step_ms:.4f} ms (graph replay) on {smi}")


def device_busy(sched, label: str, smi: str) -> None:
    """A short burst (4 requests of 20..32 prompt tokens, 6 tokens each:
    2 prefill chunks a request, then a full slot pool decoding) under
    the profiler: the share of the wall time the card spends in kernels,
    and the kernels that take it.  The burst runs once unprofiled first,
    so any graph it needs is built outside the window.  The window is
    short because reading the trace back costs far more than recording
    it."""
    from repro_torch.serve import synthetic_workload
    requests = synthetic_workload(4, sched.cfg.vocab_size, min_prompt=20,
                                  max_prompt=32, max_new=6, seed=1)
    sched.run(requests)
    steps, chunks = sched.decode_steps, sched.prefill_chunks
    res = profiled(lambda: sched.run(requests))
    if res is None:
        log(f"profile {label}: the profiler saw no device time (not "
            f"measured) on {smi}")
        return
    wall, busy, top = res
    log(f"profile {label}: {sched.decode_steps - steps} decode steps + "
        f"{sched.prefill_chunks - chunks} prefill chunks, wall "
        f"{wall:.3f} s under the profiler, kernels {busy:.3f} s "
        f"({100 * busy / wall:.1f} % busy) on {smi}; top: {top}")


# ---------------------------------------------------------------------------
# Speculative decoding (phases 3, 4, 5, 8, 10 and 12)
# ---------------------------------------------------------------------------

# the card's draft depth: 4 slots x (k + 1) = 16 rows, one K1/K2 row
# tile; k = 4 gives 20 rows, which take a second tile
SPEC_K = 3
SPEC_K_WIDE = 4


def check_row_invariance(dev, smi: str) -> None:
    """Whether a row's bits depend on how many rows run beside it, at
    Qwen2.5-3B's widths: the RMSNorm (a mean over 2048 lanes), the f32
    lm head ([M, 1, 2048] x [2048, 152064]) and a ``bf16`` gate
    projection ([M, 1, 2048] x [2048, 11008]), each at M = 1, 8, 12, 16
    and 20 rows against M = 4 (a decode step's), on the first min(M, 4)
    rows, over fresh random draws (200 for the norm, 50 for the
    projection, 20 for the head): the draws in which a row differs.
    Printed, not gated: the verify step runs its norms and float
    products position by position (``pum_linear.positionwise``) because
    of what this shows."""
    import torch
    from repro_torch.models import layers
    g = torch.Generator(device=dev).manual_seed(5)
    p = {"scale": torch.randn((2048,), generator=g, device=dev)}
    head = torch.randn((2048, 152064), generator=g, device=dev) * 0.02
    gate = (torch.randn((2048, 11008), generator=g, device=dev)
            * 0.02).to(torch.bfloat16)
    cases = {"rmsnorm": (200, torch.bfloat16,
                         lambda x: layers.rmsnorm(p, x)),
             "lm head": (20, torch.float32, lambda x: torch.matmul(x, head)),
             "bf16 projection": (50, torch.bfloat16,
                                 lambda x: torch.matmul(x, gate))}
    differ = {}
    for name, (draws, dtype, fn) in cases.items():
        differ[name] = dict.fromkeys((1, 8, 12, 16, 20), 0)
        for _ in range(draws):
            x = torch.randn((20, 1, 2048), generator=g,
                            device=dev).to(dtype)
            at4 = fn(x[:4])
            for m in differ[name]:
                r = min(m, 4)
                differ[name][m] += not torch.equal(fn(x[:m])[:r], at4[:r])
    log(f"row invariance at Qwen2.5-3B's widths, draws in which a row at M "
        f"rows differs from it at M = 4: {differ} (of 200 / 20 / 50) on "
        f"{smi}")


class SpecDrafter:
    """A spec scheduler's drafter, switched between runs of one
    scheduler (so each depth builds its steps once): the n-gram drafter
    (prompt lookahead, ``serve.spec.NgramDrafter``), or a replay of
    recorded completions, which proposes what the model will emit (every
    draft is accepted but past a request's end)."""

    def __init__(self):
        from repro_torch.serve.spec import NgramDrafter
        self.ngram = NgramDrafter()
        self.sequences: list[tuple[int, ...]] = []

    def use(self, sequences=()):
        """Replay ``sequences`` (prompt + tokens each), or with none the
        n-gram drafter."""
        self.sequences = [tuple(int(t) for t in q) for q in sequences]
        return self

    def propose(self, context, k):
        if not self.sequences:
            return self.ngram.propose(context, k)
        key = tuple(int(t) for t in context)
        for q in self.sequences:
            if q[:len(key)] == key and len(q) > len(key):
                return list(q[len(key):len(key) + k])
        return []


def spec_run(sched, requests) -> dict:
    """``timed_run`` with the run's own ``spec_stats()`` counters and
    its tokens/s without the seconds it spent building graphs."""
    before = sched.spec_stats()
    run = timed_run(sched, requests)
    after = sched.spec_stats()
    st = {k: after[k] - before[k]
          for k in ("steps", "rows", "proposed", "accepted", "emitted")}
    st["acceptance_rate"] = st["accepted"] / max(1, st["proposed"])
    st["advance_per_step"] = st["emitted"] / max(1, st["rows"])
    run["spec"] = st
    run["steady_tokens_per_s"] = run["tokens_per_s"] * run["wall_s"] / (
        run["wall_s"] - run["build_s"])
    return run


def spec_device_ms(sched) -> float:
    """Device time of one replay of the spec graph between CUDA events:
    every slot decoding at a depth of 60 tokens through its own blocks,
    greedy, the drafts zeros (the replay's work does not depend on what
    it accepts)."""
    import numpy as np
    prog = sched.program("spec")
    b, w, k = sched.num_slots, sched.table_width, sched.speculate_k
    ones = np.ones(b, np.int32)
    keys = np.stack([np.zeros(b, np.int32), np.arange(b, dtype=np.int32)],
                    axis=1)
    prog.stage(np.zeros((b, 1), np.int32), np.zeros((b, k), np.int32),
               60 * ones, keys, ones, np.zeros(b, np.int32), -ones, ones,
               (1 << 20) * ones,
               np.arange(1, b * w + 1, dtype=np.int32).reshape(b, w),
               np.zeros(b, np.int32))
    return event_ms(prog.launch, reps=20)


def replay_split(prog, reps: int = 5) -> str:
    """A compiled step's replays on its staged inputs under the
    profiler: device ms a replay in K1/K2 (``bitslice_mvm_kernel``), K3
    (its store and attention kernels), cuBLAS GEMMs (the f32 lm head)
    and everything else."""
    _, by_name = kernel_times(lambda: [prog.launch() for _ in range(reps)])
    if not by_name:
        return "not measured (the profiler saw no device time)"
    parts = {"K1/K2": 0.0, "K3": 0.0, "GEMM": 0.0, "rest": 0.0}
    for name, us in by_name.items():
        key = ("K1/K2" if "bitslice_mvm_kernel" in name else
               "K3" if "store_kernel" in name
               or "paged_attention_kernel" in name else
               "GEMM" if "gemm" in name.lower() else "rest")
        parts[key] += us / 1e3 / reps
    return ", ".join(f"{k} {v:.3f}" for k, v in parts.items()) \
        + f" (total {sum(parts.values()):.3f})"


def same_end_state(a, b) -> bool:
    """The pools of two schedulers bit-equal but for the trash block 0,
    and their recurrent rows (xLSTM's c, n, m; Mamba's h and conv
    window) bit-equal."""
    import torch
    from repro_torch.serve import kv_pool
    return all(torch.equal(x[n][1:], y[n][1:]) if kv_pool.is_paged_cache(x)
               else torch.equal(x[n], y[n])
               for x, y in zip(a.states, b.states) for n in x)


def spec_check(label: str, sched, requests, want: dict, smi: str, *,
               wide: bool = False, sampled=None) -> dict:
    """Speculative decoding on ``sched``'s model at full width, beside
    ``sched`` itself (k = 0, its geometry), whose run of ``requests``
    gave ``want``.  A scheduler at k = SPEC_K serves ``requests`` with
    the n-gram drafter, then with a replay of ``want``.  Gated: both give
    ``want`` bit for bit; each step, chunk and spec step launches the
    forward's MVMs and K3 calls (``launch_gate``), the spec graph's
    capture 252 MVM + 36 K3 at Qwen2.5-3B; one spec program and no
    decode program, each built once as a graph; on a burst of exactly
    ``num_slots`` requests (``requests``' first, all at step 0) served
    from a fresh state at k = 0 and at k = SPEC_K with each drafter, the
    pools bit-equal but for the trash block 0 and the recurrent rows
    bit-equal.  ``wide``: a scheduler at k = SPEC_K_WIDE with the
    replay drafter gives ``want`` too (20 rows a verify step: a second
    K1/K2 row tile).  ``sampled``: requests at other temperatures, whose
    k = SPEC_K tokens (n-gram) are returned for phase 8's gate.  Prints
    the acceptance rate, advance a step, decode ms/step and tokens/s
    without graph builds at k = 0 and each depth and drafter, and a
    verify replay's device ms beside a decode replay's.  Returns the
    n-gram run's launches (the spec path's first run) and, with
    ``sampled``, its tokens."""
    import dataclasses
    import gc
    import torch
    from repro_torch.serve import kv_pool
    t0 = time.perf_counter()
    cfg, mode = sched.cfg, sched.cfg.pum.mode
    mvm, attn = per_pass(cfg)
    replay = [list(r.prompt) + want[r.rid] for r in requests]
    drafter = SpecDrafter()
    spec = like(sched, speculate_k=SPEC_K, drafter=drafter)
    runs = {"k=0": timed_run(sched, requests)}
    runs["k=0"]["steady_tokens_per_s"] = runs["k=0"]["tokens_per_s"]
    runs["ngram"] = spec_run(spec, requests)
    drafter.use(replay)
    runs["replay"] = spec_run(spec, requests)
    progs, graphs = spec.step_programs(), spec.graphs_captured()[0]
    verify_launches = dict(spec.program("spec").launches)
    out = {"launches": runs["ngram"]["launches"]}
    if sampled is not None:
        drafter.use()
        out["sampled"] = spec_run(spec, sampled)["tokens"]
    if wide:
        wide_sched = like(sched, speculate_k=SPEC_K_WIDE,
                          drafter=SpecDrafter().use(replay))
        runs["k=4 replay"] = spec_run(wide_sched, requests)
        wide_ms = spec_device_ms(wide_sched)
        wide_split = replay_split(wide_sched.program("spec"))
        del wide_sched
    for run in runs.values():
        launch_gate(mode, cfg, run["steps"], run["chunks"], run["launches"])
    burst = [dataclasses.replace(r, arrival=0)
             for r in requests[:sched.num_slots]]
    sched._reset()
    base = tokens_of(sched.run(burst))
    burst_ok = {}
    for name, seqs in (("ngram", ()), ("replay", replay)):
        spec._reset()
        drafter.use(seqs)
        burst_ok[name] = (tokens_of(spec.run(burst)) == base
                          and same_end_state(sched, spec))
    decode_ms = step_device_ms(sched)
    verify_ms = spec_device_ms(spec)
    if wide:                  # where a verify replay's time goes
        splits = {"decode (k = 0)": replay_split(sched.program("decode")),
                  f"verify (k = {SPEC_K})": replay_split(
                      spec.program("spec")),
                  f"verify (k = {SPEC_K_WIDE})": wide_split}
    want_launches = {k: v for k, v in (
        (MVM_OF_MODE[mode], mvm), ("paged_attention", attn)) if k and v}
    gates = {
        f"k = {SPEC_K} gives the k = 0 tokens, n-gram and replay drafters":
            runs["ngram"]["tokens"] == runs["replay"]["tokens"] == want
            == runs["k=0"]["tokens"],
        "one spec program and no decode program, each step built once "
        "as a graph":
            progs["decode"] == 0 and progs["spec"] == 1
            and all(n == 1 for n in progs["chunk"].values())
            and graphs == 1 + len(progs["chunk"])
            and spec.step_programs() == progs,
        f"a verify step launches {want_launches}":
            verify_launches == want_launches,
        "on a burst of num_slots requests the pool (block 0 excluded) and "
        "the recurrent rows equal a k = 0 replay's, each drafter":
            all(burst_ok.values()),
    }
    if wide:
        gates[f"k = {SPEC_K_WIDE} (replay) gives the k = 0 tokens"] = \
            runs["k=4 replay"]["tokens"] == want
    failed = [k for k, ok in gates.items() if not ok]
    rows = kv_pool.slot_recurrent_bytes(spec.states)
    log(f"speculative {label} {mode}: programs {progs}; a verify step's "
        f"launches {verify_launches} (replays counted) at {sched.num_slots}"
        f" x {SPEC_K + 1} rows; " + "; ".join(
            f"{k}: {r['steps']} decode steps + {r['chunks']} chunks"
            + (f", acceptance {r['spec']['acceptance_rate']:.4f}, advance "
               f"{r['spec']['advance_per_step']:.4f} a step"
               if "spec" in r else "")
            + f", decode_ms_per_step {r['decode_ms']:.3f}, tokens_per_s "
            f"{r['steady_tokens_per_s']:.2f} without graph builds"
            for k, r in runs.items())
        + f"; device ms of a replay: decode (k = 0) {decode_ms:.4f}, "
        f"verify (k = {SPEC_K}) {verify_ms:.4f}"
        + (f", verify (k = {SPEC_K_WIDE}) {wide_ms:.4f}" if wide else "")
        + f"; per-position recurrent state {sched.num_slots} x "
        f"{SPEC_K + 1} x {rows / 1e6:.2f} MB = "
        f"{sched.num_slots * (SPEC_K + 1) * rows / 1e9:.3f} GB; check "
        f"{time.perf_counter() - t0:.1f} s; gates failed: {failed} on {smi}")
    if wide:
        log(f"speculative {label} {mode}: device ms a replay under the "
            f"profiler, " + "; ".join(f"{k}: {v}" for k, v in splits.items())
            + f" on {smi}")
    if failed:
        raise AssertionError(f"speculative {label} {mode}: {failed}")
    del spec
    gc.collect()
    torch.cuda.empty_cache()
    return out


def no_prepack_run(mode: str, want: dict[int, list[int]], smi: str
                   ) -> dict[str, int]:
    """The CLI with ``--no-prepack`` on the same trace: the float weights
    quantised on every call (K2's unpacked entry, the planes sliced a
    call) in CUDA graphs.  Gated: the prepacked run's tokens, the same
    launches a step or chunk on K2 (``launch_gate``), no packed weight.
    Returns its launches."""
    import gc
    import torch
    from repro_torch.core.prepack import PackedLinear
    from repro_torch.kernels import registry
    from repro_torch.launch import serve
    registry.reset_launches()
    res = serve.main(SERVE_ARGS + ["--pum-mode", mode, "--no-prepack"])
    torch.cuda.synchronize()
    launches = dict(registry.LAUNCHES)
    sched = res["scheduler"]
    got = launch_gate(mode, sched.cfg, sched.decode_steps,
                      sched.prefill_chunks, launches)
    raw = not any(isinstance(v, PackedLinear)
                  for blk in sched.params["blocks"]
                  for sub in blk.values() if isinstance(sub, dict)
                  for lin in sub.values() if isinstance(lin, dict)
                  for v in lin.values())
    same = tokens_of(res["completions"]) == want
    log(f"serve {mode} --no-prepack: {sched.decode_steps} decode steps + "
        f"{sched.prefill_chunks} chunks, launches {got}; the prepacked "
        f"run's tokens: {same}; float weights: {raw}; decode_ms_per_step "
        f"{res['decode_ms']:.3f} (graphs, first run) on {smi}")
    if not (same and raw):
        raise AssertionError(f"{mode} --no-prepack: tokens equal {same}, "
                             f"float weights {raw}")
    del res, sched
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def serve_phases(smi: str) -> tuple[dict[str, int], dict[str, dict]]:
    """Phases 4-5b; returns each kernel's launches on the main path
    (each mode's first run), and by mode the greedy trace's tokens and
    its decode ms/step, graphs and eager (phase 8 compares with
    them)."""
    import dataclasses
    import gc
    import torch
    launches: dict[str, int] = {}
    greedy: dict[str, dict] = {}
    for mode in SERVE_MODES:
        res, counts = serve_run(mode, smi)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        sched = res["scheduler"]
        graph_vs_eager(sched)
        first = tokens_of(res["completions"])
        # the same trace again: nothing new to build, the same tokens
        progs = sched.step_programs()
        steady = timed_run(sched, res["requests"])
        if sched.step_programs() != progs or steady["tokens"] != first:
            raise AssertionError(f"{mode}: the second run built "
                                 f"{sched.step_programs()} (had {progs}) or "
                                 f"changed its tokens")
        launch_gate(mode, sched.cfg, steady["steps"],
                    steady["chunks"], steady["launches"])
        eager_sched = like(sched, cuda_graphs=False)
        eager = timed_run(eager_sched, res["requests"])
        if eager["tokens"] != first or eager["launches"] != steady["launches"]:
            raise AssertionError(
                f"{mode}: eager run differs from the graph run: tokens equal "
                f"{eager['tokens'] == first}, launches {eager['launches']} "
                f"against {steady['launches']}")
        log(f"serve {mode} graphs vs eager, the same trace (completions "
            f"equal token for token, launches equal): decode_ms_per_step "
            f"{steady['decode_ms']:.3f} / {eager['decode_ms']:.3f}, "
            f"tokens_per_s {steady['tokens_per_s']:.2f} / "
            f"{eager['tokens_per_s']:.2f}, peak_mem_GB "
            f"{steady['peak_gb']:.2f} / {eager['peak_gb']:.2f}; eager run "
            f"{eager['wall_s']:.1f} s on {smi}")
        greedy[mode] = dict(tokens=first, graph_ms=steady["decode_ms"],
                            eager_ms=eager["decode_ms"])
        backend_parity(sched)
        step_ms = step_device_ms(sched)
        busy = 100 * step_ms / steady["decode_ms"]
        log(f"serve {mode} decode step: device {step_ms:.4f} ms a graph "
            f"replay, host {steady['decode_ms']:.3f} ms a step in the "
            f"graph run: the card busy {busy:.1f} % of a decode step (no "
            f"profiler) on {smi}")
        head_share(sched, step_ms, smi)
        device_busy(sched, f"{mode} graphs", smi)
        device_busy(eager_sched, f"{mode} eager", smi)
        greedy[mode]["replay_ms"] = step_ms
        del eager_sched
        gc.collect()
        # the prefix cache in pum and int8 (phases 4 and 5), speculative
        # decoding in every mode; phase 8 gates the spec run of its trace
        if mode != "bf16":
            for k, v in prefix_check("qwen2.5-3b", "dense", sched.cfg,
                                     sched.params, smi).items():
                launches[k] = launches.get(k, 0) + v
        sampled = [dataclasses.replace(r, temperature=t, seed=s)
                   for r, t, s in zip(res["requests"], SAMPLED_TEMPS,
                                      SAMPLED_SEEDS)] \
            if mode == "pum" else None
        spec = spec_check("qwen2.5-3b", sched, res["requests"], first,
                          smi, wide=mode == "pum", sampled=sampled)
        for k, v in spec["launches"].items():
            launches[k] = launches.get(k, 0) + v
        greedy[mode]["spec_sampled"] = spec.get("sampled")
        if mode == "int8":
            for k, v in no_prepack_run(mode, first, smi).items():
                launches[k] = launches.get(k, 0) + v
        del res, sched
        gc.collect()
        torch.cuda.empty_cache()
    return launches, greedy


# ---------------------------------------------------------------------------
# Phase 6: the AES path
# ---------------------------------------------------------------------------

FIPS197 = [  # (key, plaintext, ciphertext): Appendix C.1-C.3 and B
    ("000102030405060708090a0b0c0d0e0f", "00112233445566778899aabbccddeeff",
     "69c4e0d86a7b0430d8cdb78070b4c55a"),
    ("000102030405060708090a0b0c0d0e0f1011121314151617",
     "00112233445566778899aabbccddeeff", "dda97ca4864cdfe06eaf70a0ec0d7191"),
    ("000102030405060708090a0b0c0d0e0f101112131415161718191a1b1c1d1e1f",
     "00112233445566778899aabbccddeeff", "8ea2b7ca516745bfeafc49904b496089"),
    ("2b7e151628aed2a6abf7158809cf4f3c", "3243f6a8885a308d313198a2e0370734",
     "3925841d02dc09fbdc118597196a0b32"),
]


def check_fips197(dev) -> None:
    """The FIPS-197 vectors through the numpy oracle, the bulk cipher
    (K4's state-byte entry and the plain composition) and the DCE path,
    on the card."""
    import numpy as np
    from repro_torch.apps import aes_app

    def h(s):
        return np.frombuffer(bytes.fromhex(s), np.uint8).copy()

    for key, pt, ct in FIPS197:
        key, pt, ct = h(key), h(pt), h(ct)
        got = {"oracle": aes_app.aes_encrypt_np(pt, key),
               "dce": aes_app.aes_encrypt_dce(pt[None], key, device=dev)[0]}
        for use_kernel in (True, False):
            c = aes_app.aes_encrypt(pt[None], key, use_kernel=use_kernel,
                                    device=dev)
            back = aes_app.aes_decrypt(c, key, use_kernel=use_kernel,
                                       device=dev)
            got[f"bulk kernel={use_kernel}"] = c[0].cpu().numpy()
            if not np.array_equal(back[0].cpu().numpy(), pt):
                raise AssertionError(f"FIPS-197 decrypt failed, kernel="
                                     f"{use_kernel}, key {key.tobytes().hex()}")
        bad = [k for k, v in got.items() if not np.array_equal(v, ct)]
        if bad:
            raise AssertionError(f"FIPS-197 vector of key "
                                 f"{key.tobytes().hex()} failed on {bad}")
    log("aes: FIPS-197 Appendix B and C.1-C.3 equal through the oracle, "
        "the bulk cipher (K4's state-byte entry and plain) and the DCE "
        "path")


def aes_phase(dev, smi: str) -> dict[str, int]:
    """Phase 6; returns each kernel's launches on the AES path."""
    import gc
    import torch
    from repro_torch.apps import aes_app
    from repro_torch.kernels import registry
    from repro_torch.launch import aes
    launches: dict[str, int] = {}
    for key_bytes in (16, 24, 32):
        registry.reset_launches()
        res = aes.main(["--blocks", str(AES_BLOCKS), "--key-bytes",
                        str(key_bytes), "--seed", "0", "--device",
                        str(dev)])
        torch.cuda.synchronize()
        counts = dict(registry.LAUNCHES)
        nr = res["rounds"]
        # warm-up and timed call each: encrypt (Nr) and decrypt (Nr - 1)
        # on the state-byte entry, and nothing else
        want = {"gf2_mvm_packed": 2 * (2 * nr - 1)}
        got = (res["encrypt_launches"], res["decrypt_launches"])
        if got != (nr, nr - 1) or counts != want:
            raise AssertionError(
                f"AES-{8 * key_bytes}: K4 launches encrypt / decrypt "
                f"{got} (want {nr}, {nr - 1}); run {counts}, want {want}")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        gates = res["gates"]
        log(f"aes AES-{8 * key_bytes}: {AES_BLOCKS} blocks, "
            f"encrypt_MB_per_s={res['encrypt_mb_per_s']:.1f} "
            f"decrypt_MB_per_s={res['decrypt_mb_per_s']:.1f} on {smi}; "
            f"oracle equal on {res['oracle_blocks']} strided blocks, "
            f"round trip equal on every block, K4 launches {nr} / {nr - 1} "
            f"per encrypt / decrypt; DCE path on "
            f"{res['dce_blocks']} blocks equal, {gates.nor} NOR + "
            f"{gates.copy} copy primitives")
        pt, key = res["pt"], res["key"]
        del res
        prof = profiled(lambda: aes_app.aes_encrypt(pt, key, use_kernel=True,
                                                    device=dev))
        if prof is None:
            log(f"profile aes-{8 * key_bytes}: the profiler saw no device "
                f"time (not measured)")
        else:
            wall, busy, top = prof
            log(f"profile aes-{8 * key_bytes}: one bulk encryption, wall "
                f"{wall:.3f} s under the profiler, kernels {busy:.3f} s "
                f"({100 * busy / wall:.1f} % busy); top: {top}")
        if key_bytes == 16:
            aes_round_split(pt, key, dev)
        del pt
        gc.collect()
        torch.cuda.empty_cache()
    check_fips197(dev)
    return launches


def aes_round_split(pt, key, dev) -> None:
    """Device time of each op of one encrypt round (round 1) at the run's
    block count, each timed alone between CUDA events."""
    import torch
    from repro_torch.apps import aes_app
    from repro_torch.kernels.gf2_mvm import ops
    rks, (m_lin, _, _) = aes_app._consts(key, dev)
    sbox = torch.as_tensor(aes_app.SBOX, device=dev)
    s = pt ^ rks[0]
    idx = s.long()
    sub = sbox[idx]
    lin = ops.gf2_mvm_packed(sub, m_lin)
    parts = {"index s.long()": event_ms(lambda: s.long()),
             "S-box gather sbox[idx]": event_ms(lambda: sbox[idx]),
             "K4 gf2_mvm_packed": event_ms(
                 lambda: ops.gf2_mvm_packed(sub, m_lin)),
             "round-key XOR": event_ms(lambda: lin ^ rks[1])}
    total = sum(parts.values())
    log(f"aes round split at {pt.shape[0]} blocks (round 1, each op timed "
        f"alone): " + ", ".join(f"{k} {v:.4f} ms ({100 * v / total:.1f} %)"
                                for k, v in parts.items())
        + f"; sum {total:.4f} ms")


# ---------------------------------------------------------------------------
# Phase 7: the CNN path (ResNet-20 on CIFAR-10 shapes, paper §5.1, §7.5)
# ---------------------------------------------------------------------------

CNN_IMAGES = 1024
CNN_WIDTH = 16
SWEEP_IMAGES = 256
SIGMAS = (0.0, 0.02, 0.05, 0.1, 0.3)
# the JAX package's bound on agreement without noise (tests/test_apps.py)
CLEAN_AGREEMENT = 0.75
# K2's launches in one ResNet-20 forward: (layer, rows per image, K, N,
# launches); the stride-2 conv im2cols at full size, then subsamples
CNN_LAYERS = [("stem", 1024, 27, 16, 1),
              ("stage-0 conv", 1024, 144, 16, 6),
              ("s1b0.conv1", 256, 144, 32, 1),
              ("stage-1 conv", 256, 288, 32, 5),
              ("s1 projection", 256, 16, 32, 1),
              ("s2b0.conv1", 64, 288, 64, 1),
              ("stage-2 conv", 64, 576, 64, 5),
              ("s2 projection", 64, 32, 64, 1),
              ("classifier", 1, 64, 10, 1)]
CNN_LAUNCHES = sum(layer[-1] for layer in CNN_LAYERS)     # 22


def check_cnn_mvm(dev, gpu_name: str) -> list[dict]:
    """K2's unpacked entry (planes sliced per call, N padded to 16) at
    each ResNet-20 layer shape over CNN_IMAGES images, bit for bit
    against its plain version, two calls bit-equal, timed beside its
    byte bound and ``torch._int_mm`` on the recombined weight (K and N
    padded to multiples of 8, as it requires; the padding not timed)."""
    import torch
    from repro_torch.kernels import registry
    from repro_torch.kernels.bitslice_mvm import ops
    bw, _, int8_rate = peaks(gpu_name)
    g = torch.Generator(device=dev).manual_seed(7)
    props = registry.device_props(dev.index)
    rows = []
    for name, per_image, k, n, _ in CNN_LAYERS:
        m = per_image * CNN_IMAGES
        x = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                          dtype=torch.int32).to(torch.int8)
        wq = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                           dtype=torch.int32)

        def kern():
            return ops.bitslice_mvm(x, wq, backend="cuda")

        def plain():
            return ops.bitslice_mvm(x, wq, backend="torch")

        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not torch.equal(got, want) or not deterministic(kern):
            raise AssertionError(f"bitslice_mvm (unpacked) at {name} M={m} "
                                 f"K={k} N={n}: max|diff| {err}, or two "
                                 f"calls differ")
        del got, want
        plan = ops.mvm_plan(m, k, -(-n // ops.VEC) * ops.VEC, 4, props)
        t = device_ms(kern, iters=10)
        p = device_ms(plain, iters=3, reps=2)
        k8, n8 = -(-k // 8) * 8, -(-n // 8) * 8
        xl = torch.zeros((max(m, 17), k8), dtype=torch.int8, device=dev)
        xl[:m, :k] = x
        wl = torch.zeros((k8, n8), dtype=torch.int8, device=dev)
        wl[:k, :n] = wq.to(torch.int8)
        lib = device_ms(lambda: torch._int_mm(xl, wl), iters=10)
        s = 4                        # planes of 8-bit weights, 2-bit cells
        nbytes = m * k + 4 * s * k * n + 4 * m * n
        by_bytes, by_ops = nbytes / bw * 1e3, mvm_ops(m, k, n) / int8_rate \
            * 1e3
        bound = max(by_bytes, by_ops)
        log(f"cnn mvm {name} M={m} K={k} N={n} S={s} (grid z "
            f"{plan.grid_rows} CTAs over {plan.row_tiles} row tiles of "
            f"{plan.mt}): exact, two calls bit-equal | kernel {t:.4f} ms "
            f"(plain {p:.4f}, bound {bound:.4f}, {share(bound, t)} of "
            f"bound) | _int_mm {lib:.4f} ms")
        rows.append(dict(shape=f"{name} M={m} K={k} N={n} S={s}",
                         max_abs_err=err, ms=t, plain_ms=p, bound_ms=bound,
                         bound_by="bytes" if by_bytes >= by_ops
                         else "operations", library_ms=lib))
        del x, xl
    return rows


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def cnn_phase(dev, gpu_name: str, smi: str) -> tuple[dict[str, int],
                                                      list[dict]]:
    """Phase 7: ResNet-20 at its published width on the card.  Returns
    K2's launches on the path (the gated forward) and its rows at the
    layer shapes."""
    import gc
    import torch
    from repro_torch.apps import resnet_app
    from repro_torch.kernels import registry
    from repro_torch.models import resnet
    rows = check_cnn_mvm(dev, gpu_name)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    log(f"cnn: torch.backends.cuda.matmul.allow_tf32={tf32} (the f32 "
        f"reference runs in full f32)")
    if tf32:
        raise AssertionError("f32 matmuls would run on TF32")
    gen = torch.Generator(dev).manual_seed(0)
    params = resnet.resnet20_init(gen, width=CNN_WIDTH, device=dev)
    x, _ = resnet_app.synthetic_images(gen, CNN_IMAGES, device=dev)
    n_weights = sum(t.numel() for t in _leaves(params) if t.ndim == 2)
    pum = resnet_app.pum_config(0.0)

    def forward(cfg):
        with torch.no_grad():
            return resnet.resnet20_apply(params, x, cfg)

    # the main path: counts set to 0 just before, read just after
    registry.reset_launches()
    logits = forward(pum)
    torch.cuda.synchronize()
    launches = dict(registry.LAUNCHES)
    if launches != {"bitslice_mvm": CNN_LAUNCHES}:
        raise AssertionError(f"cnn: launches {launches}, want "
                             f"{CNN_LAUNCHES} of bitslice_mvm and no other")
    with registry.use_backend("torch"):
        plain = forward(pum)
    again = forward(pum)
    finite = bool(torch.isfinite(logits).all())
    same_plain, same_again = torch.equal(logits, plain), \
        torch.equal(logits, again)
    log(f"cnn: ResNet-20 width {CNN_WIDTH} ({n_weights} weights), "
        f"{CNN_IMAGES} images, pum: {launches['bitslice_mvm']} bitslice_mvm "
        f"launches a forward, none of bitslice_mvm_scaled; logits "
        f"{tuple(logits.shape)} bit-equal to the torch backend's: "
        f"{same_plain} (max|diff| "
        f"{(logits - plain).abs().max().item():.3g}), two runs bit-equal: "
        f"{same_again}, finite: {finite}")
    if not (finite and same_plain and same_again
            and logits.shape == (CNN_IMAGES, 10)):
        raise AssertionError("cnn: pum forward failed its gates")
    del plain, again
    floats = forward(resnet_app.FLOAT)
    agree = float((logits.argmax(-1) == floats.argmax(-1)).float().mean())
    rel = ((logits - floats).abs().max() / floats.abs().max()).item()
    log(f"cnn: pum vs float (f32 torch.matmul) on {CNN_IMAGES} images: "
        f"argmax agreement {agree:.4f}, max|diff| / max|float logit| "
        f"{rel:.4f}")
    del floats
    ms = {mode: event_ms(lambda: forward(cfg), reps=5)
          for mode, cfg in (("pum", pum), ("bf16", resnet_app.FLOAT))}
    log("cnn: " + ", ".join(f"{mode} {CNN_IMAGES / ms[mode] * 1e3:.1f} "
                            f"images/s ({ms[mode]:.3f} ms a forward of "
                            f"{CNN_IMAGES})" for mode in ms)
        + f" on {smi}")
    wall, by_name = kernel_times(lambda: forward(pum))
    if by_name:
        total = sum(by_name.values()) / 1e3
        k2 = sum(us for name, us in by_name.items()
                 if "bitslice_mvm_kernel" in name) / 1e3
        log(f"cnn profile pum forward: device {total:.3f} ms, K2 "
            f"{k2:.3f} ms ({100 * k2 / total:.1f} %) over "
            f"{CNN_LAUNCHES} launches, wall {wall * 1e3:.3f} ms under the "
            f"profiler ({100 * total / 1e3 / wall:.1f} % busy); top 5: "
            f"{top_kernels(by_name, 5)}")
    else:
        log("cnn profile: the profiler saw no device time (not measured)")
    del logits
    gc.collect()
    torch.cuda.empty_cache()

    # the §7.5 agreement sweep, as benchmarks/noise_accuracy.py runs it
    xs = x[:SWEEP_IMAGES]
    agreement = {}
    for sigma in SIGMAS:
        agreement[sigma] = resnet_app.agreement(
            params, xs, sigma, torch.Generator(dev).manual_seed(1))
    noisy_cfg = resnet_app.pum_config(0.05)

    def noisy(seed):
        with torch.no_grad():
            return resnet.resnet20_apply(
                params, xs, noisy_cfg,
                generator=torch.Generator(dev).manual_seed(seed))

    t0 = time.perf_counter()
    a = noisy(1)
    torch.cuda.synchronize()
    noisy_s = time.perf_counter() - t0
    b, c = noisy(1), noisy(2)
    with torch.no_grad():
        clean = resnet.resnet20_apply(params, xs, pum)
    drawn, repeat, reseeded = not torch.equal(a, clean), torch.equal(a, b), \
        not torch.equal(a, c)
    log(f"cnn noise sweep (width {CNN_WIDTH}, {SWEEP_IMAGES} images, SAR "
        f"ADC 10 bits): agreement with the float model "
        + ", ".join(f"sigma={s}: {v:.4f}" for s, v in agreement.items())
        + f"; noise on (sigma 0.05) differs from off: {drawn}, the same "
        f"seed twice bit-equal: {repeat}, another seed differs: {reseeded}; "
        f"one noisy forward {noisy_s:.2f} s (ACE simulation)")
    if not (agreement[0.0] >= CLEAN_AGREEMENT
            and agreement[0.3] <= agreement[0.0] and drawn and repeat
            and reseeded):
        raise AssertionError("cnn: the noise sweep failed its gates")
    return {"bitslice_mvm": launches["bitslice_mvm"]}, rows


# ---------------------------------------------------------------------------
# Phase 8: sampled serving (temperature > 0 from threefry keys)
# ---------------------------------------------------------------------------

# phase 4's six requests (the same prompts: the trace's temperatures and
# seeds are drawn after its prompts) at these temperatures, a seed each
SAMPLED_TEMPS = (0.0, 0.7, 1.0, 0.0, 0.7, 1.0)
SAMPLED_SEEDS = (1001, 1002, 1003, 1004, 1005, 1006)
# Threefry-2x32 known answers: (key, count) -> output, 20 rounds
THREEFRY_KAT = [((0x13198a2e, 0x03707344, 0x243f6a88, 0x85a308d3),
                 (0xc4923a9c, 0x483df7a0)),
                ((0, 0, 0, 0), (0x6b200159, 0x99ba4efe))]
# CUDA's logf and the CPU's log may differ by an ulp: the card's Gumbel
# values lie within GUMBEL_ULPS ulps of max(|g|, 1) of the CPU's, and a
# draw may differ from the CPU's only where the CPU's top-2 score margin
# is within NEAR_TIE, far above that difference (2 ulps of a value
# below 17 are under 4e-6)
GUMBEL_ULPS = 2
NEAR_TIE = 1e-5
# a decode step's logits: 4 slots x Qwen2.5-3B's padded vocabulary
SAMPLER_ROWS, SAMPLER_VOCAB = 4, 152064
CATEGORICAL_ROWS = 64
# the distribution check: 2^20 rows, a key each, one 16-way categorical
# at t = 0.7; every class's frequency within 5 sigma of softmax(l / t)
DIST_ROWS, DIST_T, DIST_SIGMAS = 1 << 20, 0.7, 5.0
DIST_LOGITS = [0.0, 1.0, -1.0, 2.0, 0.5, -0.5, 1.5, -2.0, 0.25, -0.25,
               0.75, -0.75, 1.25, -1.25, 0.1, -3.0]
# greedy decode ms/step, graphs, of the same trace recorded before the
# sampler was part of the decode graph (PERF.md §6: an H100 80GB HBM3 at
# 700 W)
PRE_SAMPLER_GREEDY_MS = {"pum": 17.046, "int8": 17.776, "bf16": 14.369}


def _u32(t) -> list[int]:
    return t.cpu().numpy().view("uint32").tolist()


def check_sampler(dev, smi: str) -> float:
    """The sampler (``serve/prng.py`` and ``sample_token``) on the card
    against its own CPU result and against its definition.  Returns its
    device ms at a decode step's shapes."""
    import numpy as np
    import torch
    from repro_torch.serve import prng
    from repro_torch.serve.engine import sample_token
    for words, want in THREEFRY_KAT:
        got = prng.threefry2x32(*(
            torch.from_numpy(np.array([w], np.uint32).view(np.int32)).to(dev)
            for w in words))
        if [_u32(t)[0] for t in got] != list(want):
            raise AssertionError(f"threefry2x32{words}: "
                                 f"{[hex(_u32(t)[0]) for t in got]}")
    b, v = SAMPLER_ROWS, SAMPLER_VOCAB
    one = prng.prng_key(7)
    rows = torch.stack([prng.prng_key(s) for s in range(b)])
    worst = 0.0
    for key, shape in ((one, (b, v)), (rows, (v,))):
        for fn in (prng.random_bits, prng.uniform):
            if not torch.equal(fn(key.to(dev), shape).cpu(), fn(key, shape)):
                raise AssertionError(f"{fn.__name__} on the card differs "
                                     f"from the CPU's")
        got = prng.gumbel(key.to(dev), shape).cpu().numpy()
        want = prng.gumbel(key, shape).numpy()
        ulps = np.abs(got - want) / np.spacing(
            np.maximum(np.abs(want), 1).astype(np.float32))
        worst = max(worst, float(ulps.max()))
    if worst > GUMBEL_ULPS:
        raise AssertionError(f"gumbel {worst} ulps from the CPU's")
    g = torch.Generator().manual_seed(8)
    logits = 3 * torch.randn((CATEGORICAL_ROWS, v), generator=g)
    near_ties = draws = 0
    for key in (prng.prng_key(9), torch.stack(
            [prng.prng_key(s) for s in range(CATEGORICAL_ROWS)])):
        got = prng.categorical(key.to(dev), logits.to(dev)).cpu()
        want = prng.categorical(key, logits)
        shape = logits.shape[key.ndim - 1:]
        top2 = torch.topk(prng.gumbel(key, shape) + logits, 2).values
        near = (top2[:, 0] - top2[:, 1]) <= NEAR_TIE
        if not torch.equal(got[~near], want[~near]):
            raise AssertionError("categorical draws on the card differ from "
                                 "the CPU's away from a near-tie")
        near_ties += int(near.sum())
        draws += len(got)
    log(f"sampler: threefry2x32 known answers equal on the card; random "
        f"bits and uniforms over [{b}, {v}] (one key) and {b} x [{v}] (a "
        f"key a row) bit-equal to the CPU's; gumbel within {worst:.0f} "
        f"ulps of max(|g|, 1) of the CPU's (bound {GUMBEL_ULPS}); "
        f"categorical draws equal on {draws - near_ties} of {draws}, "
        f"{near_ties} near-ties (CPU top-2 margin <= {NEAR_TIE}) not "
        f"compared")
    # the distribution: 2^20 rows, a key each, one categorical at t = 0.7
    n = DIST_ROWS
    keys = prng.fold_in(prng.prng_key(2024, dev).expand(n, 2),
                        torch.arange(n, dtype=torch.int32, device=dev))
    dist = torch.tensor(DIST_LOGITS, device=dev).expand(n, 1, -1)
    tok = sample_token(dist, keys, torch.full((n,), DIST_T, device=dev))
    freq = torch.bincount(tok[:, 0].long(), minlength=len(DIST_LOGITS))
    freq = freq.cpu().numpy() / n
    scaled = np.array(DIST_LOGITS, np.float64) / np.float32(DIST_T)
    p = np.exp(scaled - scaled.max())
    p /= p.sum()
    z = (freq - p) / np.sqrt(p * (1 - p) / n)
    log(f"sampler distribution: {n} rows at t = {DIST_T}, 16 classes: "
        f"max |freq - softmax(l / t)| = {np.abs(freq - p).max():.3g}, "
        f"max |z| = {np.abs(z).max():.2f} (bound {DIST_SIGMAS:.0f} sigma)")
    if np.abs(z).max() > DIST_SIGMAS:
        raise AssertionError(f"sampled frequencies {freq} against {p}")
    # the sampler alone at a decode step's shapes: fold the keys, draw
    g = torch.Generator(device=dev).manual_seed(9)
    step_logits = torch.randn((b, 1, v), generator=g, device=dev)
    step_keys = rows.to(dev)
    gen = torch.arange(1, b + 1, dtype=torch.int32, device=dev)
    temps = torch.tensor([0.0, 0.7, 1.0, 0.7], device=dev)
    ms = device_ms(lambda: sample_token(
        step_logits, prng.fold_in(step_keys, gen - 1), temps))
    log(f"sampler at a decode step's shapes ([{b}, 1, {v}] f32 logits, "
        f"{b} keys folded): {ms:.4f} ms of device time on {smi}")
    return ms


def sampled_run(mode: str, greedy: dict, sampler_ms: float,
                smi: str) -> dict[str, int]:
    """Phase 8 in one mode: the CLI at ``--temperature 0.7`` (the main
    path; its launches are returned), then, on its scheduler, phase 4's
    requests at ``SAMPLED_TEMPS``, each seeded, with every gate."""
    import dataclasses
    import torch
    from repro_torch.kernels import registry
    from repro_torch.launch import serve
    from repro_torch.serve import oracle_completion
    registry.reset_launches()
    res = serve.main(SERVE_ARGS + ["--pum-mode", mode, "--temperature",
                                   "0.7"])
    torch.cuda.synchronize()
    launches = dict(registry.LAUNCHES)
    sched = res["scheduler"]
    cfg = sched.cfg
    comps = res["completions"]
    vp = sched.params["embed"].shape[0]
    if len(comps) != 6 or any(
            len(c.tokens) != 16 or not all(0 <= t < vp for t in c.tokens)
            for c in comps.values()):
        raise AssertionError(f"sampled {mode}: CLI completions "
                             f"{[(c.rid, c.tokens) for c in comps.values()]}")
    launch_gate(mode, cfg, sched.decode_steps,
                sched.prefill_chunks, launches)
    progs = sched.step_programs()
    if progs["decode"] != 1 or any(n != 1 for n in progs["chunk"].values()):
        raise AssertionError(f"sampled {mode}: programs {progs}")
    reqs = [dataclasses.replace(r, temperature=t, seed=s) for r, t, s in
            zip(res["requests"], SAMPLED_TEMPS, SAMPLED_SEEDS)]
    first = timed_run(sched, reqs)
    again = timed_run(sched, reqs)
    reseeded = timed_run(sched, [dataclasses.replace(r, seed=r.seed + 1)
                                 for r in reqs])
    eager = timed_run(like(sched, cuda_graphs=False), reqs)
    tokens = first["tokens"]
    t0 = time.perf_counter()
    # each request alone through the same kernels: co-tenants never move
    # a row's numerics, so each comes back as in the mixed batch
    alone = {r.rid: tokens_of(sched.run([r]))[r.rid] for r in reqs}
    # the port's solo oracle, generate_loop, keeps a contiguous cache and
    # attends through the plain composition, never K3, whose f32 sums
    # run in another order (backend parity): it equals the scheduler bit
    # for bit where both run the same arithmetic, the torch backend
    plain = like(sched, cuda_graphs=True, kernel_backend="torch")
    plain_tokens = tokens_of(plain.run(reqs))
    solo = {r.rid: oracle_completion(plain.engine, r) for r in reqs}
    solo_s = time.perf_counter() - t0
    cold = [r.rid for r in reqs if r.temperature == 0]
    hot = [r.rid for r in reqs if r.temperature > 0]
    hottest = [r.rid for r in reqs if r.temperature == 1.0]
    gates = {
        "each completion equals the request served alone": tokens == alone,
        "the torch backend's completions equal their solo generate_loop":
            plain_tokens == solo,
        "graphs and eager give the same tokens and launches":
            eager["tokens"] == tokens
            and eager["launches"] == first["launches"],
        "the temperature-0 requests give phase 4's tokens":
            all(tokens[r] == greedy["tokens"][r] for r in cold),
        "one decode program, nothing new built":
            sched.step_programs() == progs,
        "the same seeds give the same tokens": again["tokens"] == tokens,
        "other seeds give other tokens (greedy rows unchanged)":
            any(reseeded["tokens"][r] != tokens[r] for r in hot)
            and all(reseeded["tokens"][r] == tokens[r] for r in cold),
        "at t = 1.0 a token differs from the greedy one":
            any(tokens[r] != greedy["tokens"][r] for r in hottest),
    }
    if mode == "pum":
        gates[f"phase 4's speculative run (k = {SPEC_K}, n-gram) of this "
              f"trace gave these tokens"] = greedy["spec_sampled"] == tokens
    for run in (first, again, reseeded, eager):
        launch_gate(mode, cfg, run["steps"], run["chunks"],
                    run["launches"])
    failed = [k for k, ok in gates.items() if not ok]
    log(f"sampled {mode}: 6 requests at temperatures {list(SAMPLED_TEMPS)}, "
        f"seeds {list(SAMPLED_SEEDS)}; launches {first['launches']} over "
        f"{first['steps']} decode steps + {first['chunks']} chunks (252 MVM "
        f"+ 36 attention a step or chunk); programs {sched.step_programs()}; "
        f"solo runs {solo_s:.1f} s; gates failed: {failed}")
    if failed:
        raise AssertionError(f"sampled {mode}: {failed}")
    if mode == "pum":
        # not a gate: the cuda backend against the contiguous oracle
        diff = {}
        for r in reqs:
            want = oracle_completion(sched.engine, r)
            diff[r.rid] = next((i for i, (a, b) in enumerate(
                zip(tokens[r.rid], want)) if a != b), None)
        log(f"sampled {mode}: the cuda backend's completions against "
            f"generate_loop on the cuda backend (contiguous cache, plain "
            f"attention): first differing token by request {diff} (None: "
            f"equal)")
    replay_ms = step_device_ms(sched, temps=[0.0, 0.7, 1.0, 0.7])
    log(f"sampled {mode}: decode_ms_per_step graphs / eager "
        f"{again['decode_ms']:.3f} / {eager['decode_ms']:.3f}, tokens_per_s "
        f"{again['tokens_per_s']:.2f} / {eager['tokens_per_s']:.2f}; a "
        f"decode replay {replay_ms:.4f} ms of device time (phases 4-5, every "
        f"row greedy: {greedy['replay_ms']:.4f}); the sampler alone "
        f"{sampler_ms:.4f} ms = {100 * sampler_ms / replay_ms:.1f} % of the "
        f"replay on {smi}")
    return launches


def sampled_phase(greedy: dict[str, dict], smi: str) -> dict[str, int]:
    """Phase 8; returns each kernel's launches on its main path (the
    CLI's sampled run in each mode)."""
    import gc
    import torch
    dev = torch.device("cuda", 0)
    sampler_ms = check_sampler(dev, smi)
    launches: dict[str, int] = {}
    for mode in ("pum", "int8"):
        for k, v in sampled_run(mode, greedy[mode], sampler_ms,
                                smi).items():
            launches[k] = launches.get(k, 0) + v
        gc.collect()
        torch.cuda.empty_cache()
    log("greedy decode_ms_per_step with the sampler in the decode graph "
        "(phases 4-5b, graphs / eager): " + ", ".join(
            f"{m} {greedy[m]['graph_ms']:.3f} / {greedy[m]['eager_ms']:.3f}"
            f" (before the sampler, graphs: {PRE_SAMPLER_GREEDY_MS[m]})"
            for m in SERVE_MODES)
        + f" on {smi}")
    return launches


# ---------------------------------------------------------------------------
# Phase 9: contiguous serving (contiguous windows, online softmax, the
# static batch)
# ---------------------------------------------------------------------------

# phase 9 serves Qwen2.5-3B at full width cut to CONTIG_LAYERS of its 36
# layers (phases 4-8 serve all 36; every gate of phase 9 compares runs
# on one backend, bit for bit, and holds at any depth): 12 paid for
# phase 13, 6 for phase 15 on a slow host (1103 s at 12)
CONTIG_LAYERS = 6
# phase 4's trace served from contiguous windows: the CLI's defaults
# but for the KV layout (no blocks, so no chunked prefill)
CONTIG_ARGS = [a for a in SERVE_ARGS if a != "--chunked-prefill"]
CONTIG_ARGS[CONTIG_ARGS.index("--kv-block-size") + 1] = "0"
# one request of LONG_PROMPT tokens, past 2 * CHUNK_Q: its prefill runs
# the online softmax at full width, and every row of the scheduler then
# attends over a window of LONG_MAX_LEN keys
LONG_PROMPT, LONG_TOKENS = 4096, 16
LONG_MAX_LEN = LONG_PROMPT + LONG_TOKENS + 1
LONG_TEMP, LONG_SEED = 0.7, 2001
# the static batch of the reference CLI's default run
STATIC_ARGS = ["--arch", "qwen2.5-3b", "--batch-slots", "0", "--batch",
               "4", "--prompt-len", "64", "--gen", "16", "--seed", "0",
               "--device", "cuda"]
STATIC_TEMPS = (0.0, 0.7)
# _chunked_attention against the plain composition, bf16 K/V: each
# rounds p to bf16 (2^-8 relative; the online softmax rounds it against
# the running max, the plain one after normalising) and its p @ V
# products to bf16 (the online softmax each key block's partial sum,
# the plain one the output), so each is within 2^-7 of the exact
# output, relative to E = sum_t p_t |v_t|, the p-weighted mean |V| of
# that output element: |chunked - plain| <= 2^-6 E, plus 1e-6 for the
# f32 sums' order (scores and exp agree to ~1e-7 relative).  E is
# read in the same run, from the plain composition's f32 probabilities.
CHUNK_ATTN_REL = 2.0 ** -6
CHUNK_ATTN_ABS = 1e-6
# K1 / K2 at a monolithic prefill's M on Qwen2.5-3B's gate/up shape
PREFILL_MVM = (LONG_PROMPT, 2048, 11008)


def check_chunked_attention(dev, smi: str) -> None:
    """One layer's ``_chunked_attention`` at the 4096-token prompt's
    shapes (Qwen2.5-3B's 2 KV heads of 8 queries, hd 128, a window of
    LONG_MAX_LEN bf16 keys) against the plain composition over the same
    queries and keys, within the bound derived at CHUNK_ATTN_REL, and
    both timed."""
    import torch
    from repro_torch.kernels.paged_attention import ref
    from repro_torch.models import attention
    g = torch.Generator(device=dev).manual_seed(11)
    s, t = LONG_PROMPT, LONG_MAX_LEN
    q = torch.randn((1, s, 2, 8, 128), generator=g, device=dev).to(
        torch.bfloat16)
    k, v = (torch.randn((1, t, 2, 128), generator=g, device=dev).to(
        torch.bfloat16) for _ in range(2))
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    mask = torch.arange(t, device=dev)[None, :] <= torch.arange(
        s, device=dev)[:, None]
    got = attention._chunked_attention(q, k, v, zero, 0.0)
    plain = ref.plain_attention(q, k, v, mask, 0.0).float()
    scores = torch.einsum("bskgd,btkd->bksgt", q.float(), k.float()) \
        / math.sqrt(128)
    probs = ref.softmax(torch.where(mask[None, None, :, None, :], scores,
                                    torch.full((), ref.NEG_INF,
                                               device=dev)), 0.0)
    weighted = torch.einsum("bksgt,btkd->bskgd", probs, v.float().abs())
    del scores, probs
    err = (got - plain).abs()
    bound = CHUNK_ATTN_REL * weighted + CHUNK_ATTN_ABS
    finite = bool(torch.isfinite(got).all())
    worst = (err / bound).max().item()
    ms = event_ms(lambda: attention._chunked_attention(q, k, v, zero, 0.0),
                  reps=3)
    plain_ms = event_ms(lambda: ref.plain_attention(q, k, v, mask, 0.0),
                        reps=3)
    log(f"chunked attention S={s} T={t} KV=2 G=8 hd=128 bf16: max|chunked "
        f"- plain| = {err.max().item():.3g}, at most {worst:.3f} of the "
        f"bound 2^-6 E + 1e-6 (max E {weighted.max().item():.3g}, max|out| "
        f"{plain.abs().max().item():.3g}), finite {finite} | online "
        f"softmax {ms:.3f} ms, plain composition {plain_ms:.3f} ms on {smi}")
    if not finite or worst > 1.0:
        raise AssertionError("chunked attention outside its bound")


def check_prefill_mvm(dev, gpu_name: str) -> dict[str, dict]:
    """K1 and K2 alone at a monolithic prefill's M (PREFILL_MVM), bit for
    bit against their plain versions, timed beside their bounds and
    ``torch._int_mm``.  Returns each kernel's row."""
    import torch
    from repro_torch.core import bitslice
    from repro_torch.kernels import registry
    from repro_torch.kernels.bitslice_mvm import ops
    bw, _, int8_rate = peaks(gpu_name)
    m, k, n = PREFILL_MVM
    g = torch.Generator(device=dev).manual_seed(12)
    wq = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                       dtype=torch.int32)
    planes = bitslice.slice_planes_signed(wq, 8, 2).to(torch.int8)
    one = wq.to(torch.int8)[None]
    x = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                      dtype=torch.int32).to(torch.int8)
    scale = torch.rand((m, 1), generator=g, device=dev) * 1e-3
    calls = {
        "bitslice_mvm_scaled": lambda backend: ops.bitslice_mvm_planes_scaled(
            x, planes, scale, backend=backend),
        "bitslice_mvm": lambda backend: ops.bitslice_mvm_planes(
            x, one, bits_per_slice=8, backend=backend)}
    planes_of = {"bitslice_mvm_scaled": 4, "bitslice_mvm": 1}
    lib = device_ms(lambda: torch._int_mm(x, one[0]), iters=5)
    plan = ops.mvm_plan(m, k, n, 4, registry.device_props(dev.index))
    rows = {}
    for name, call in calls.items():
        got, want = call("cuda"), call("torch")
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if not torch.equal(got, want) or not deterministic(
                lambda: call("cuda")):
            raise AssertionError(f"{name} at M={m} K={k} N={n}: max|diff| "
                                 f"{err}, or two calls differ")
        del got, want
        ps = planes_of[name]
        out_bytes = 4 * m * n
        nbytes = m * k + ps * k * n + out_bytes + (4 * m if ps == 4 else 0)
        by_bytes = nbytes / bw * 1e3
        by_ops = mvm_ops(m, k, n) / int8_rate * 1e3
        t = device_ms(lambda: call("cuda"), iters=5)
        p = device_ms(lambda: call("torch"), iters=2, reps=2)
        bound = max(by_bytes, by_ops)
        log(f"prefill mvm {name} M={m} K={k} N={n} S={ps} ({plan.row_tiles} "
            f"row tiles of {plan.mt}, {plan.col_tiles} column tiles): exact, "
            f"two calls bit-equal | kernel {t:.4f} ms (plain {p:.4f}, bound "
            f"{bound:.4f} by {'bytes' if by_bytes >= by_ops else 'ops'}, "
            f"{share(bound, t)} of bound) | _int_mm {lib:.4f} ms")
        rows[name] = dict(shape=f"M={m} K={k} N={n} S={ps}", max_abs_err=err,
                          ms=t, plain_ms=p, bound_ms=bound,
                          bound_by="bytes" if by_bytes >= by_ops
                          else "operations", library_ms=lib)
    return rows


def first_difference(a: dict, b: dict) -> dict:
    """By request: the first token where ``a`` and ``b`` differ (None:
    equal)."""
    return {rid: next((i for i, (x, y) in enumerate(zip(a[rid], b[rid]))
                       if x != y), None) for rid in a}


def long_request(vocab: int):
    """The LONG_PROMPT-token request, its prompt drawn from LONG_SEED."""
    import torch
    from repro_torch.serve import Request
    g = torch.Generator().manual_seed(LONG_SEED)
    prompt = torch.randint(0, vocab, (LONG_PROMPT,), generator=g).tolist()
    return Request(prompt, LONG_TOKENS, temperature=LONG_TEMP,
                   seed=LONG_SEED, rid=6)


def contiguous_long(sched, reqs, mode: str, smi: str) -> None:
    """Phase 4's requests at phase 8's temperatures plus the 4096-token
    request on a contiguous scheduler of LONG_MAX_LEN, gated against
    each request served alone through ``generate_loop`` on the same
    (cuda) backend; the long prompt's prefill timed and profiled."""
    import numpy as np
    import torch
    from repro_torch.kernels import registry
    from repro_torch.serve import ContinuousBatchingScheduler
    from repro_torch.serve import oracle_completion, prng
    cfg = sched.cfg
    big = ContinuousBatchingScheduler(cfg, sched.params,
                                      num_slots=sched.num_slots,
                                      max_len=LONG_MAX_LEN, kv_block_size=0,
                                      device=sched.device)
    long_req = long_request(cfg.vocab_size)
    trace = reqs + [long_req]
    run = timed_run(big, trace)
    launch_gate(mode, cfg, run["steps"], run["chunks"],
                run["launches"], paged=False)
    progs = big.step_programs()
    lengths = {len(r.prompt) for r in trace}
    t0 = time.perf_counter()
    solo = {r.rid: oracle_completion(big.engine, r) for r in trace}
    solo_s = time.perf_counter() - t0
    gates = {
        "each completion equals its request alone through generate_loop "
        "(cuda backend)": run["tokens"] == solo,
        "16 tokens a request": all(len(t) == 16
                                   for t in run["tokens"].values()),
        "one decode program, one prefill program a prompt length":
            progs == {"decode": 1, "prefill": {n: 1 for n in lengths}},
    }
    failed = [k for k, ok in gates.items() if not ok]
    replay_ms = step_device_ms(big)
    log(f"contiguous {mode} long: 6 requests at {list(SAMPLED_TEMPS)} + one "
        f"of {LONG_PROMPT} prompt tokens at t = {LONG_TEMP}, window "
        f"{LONG_MAX_LEN}; launches {run['launches']} over {run['steps']} "
        f"decode steps + {run['chunks']} prefills; programs {progs}; "
        f"decode_ms_per_step {run['decode_ms']:.3f}, a decode replay "
        f"{replay_ms:.4f} ms (4 rows over {LONG_MAX_LEN} keys), peak_mem_GB "
        f"{run['peak_gb']:.2f}; solo runs {solo_s:.1f} s; gates failed: "
        f"{failed}")
    if failed:
        diff = first_difference(run["tokens"], solo)
        raise AssertionError(f"contiguous {mode} long: {failed}; first "
                             f"differences {diff}")
    # the long prompt's prefill (time to first token): its program
    # replayed into the idle slot 0
    prog = big.program(LONG_PROMPT)
    key = prng.prng_key(long_req.seed).numpy()
    prog.stage([long_req.prompt], 0, key,
               np.float32(long_req.temperature).view(np.int32))
    ttft_ms = event_ms(prog.launch, reps=3)
    wall, by_name = kernel_times(prog.launch)
    if by_name:
        total = sum(by_name.values()) / 1e3
        mvm = sum(us for name, us in by_name.items()
                  if "bitslice_mvm_kernel" in name) / 1e3
        prof = (f"under the profiler {total:.3f} ms of kernels, the MVM "
                f"kernel {mvm:.3f} ms ({100 * mvm / total:.1f} %); top: "
                f"{top_kernels(by_name, 5)}")
    else:
        prof = "the profiler saw no device time (not measured)"
    log(f"contiguous {mode} long prefill: {LONG_PROMPT} tokens, one replay "
        f"{ttft_ms:.3f} ms of device time (time to first token), "
        f"{prog.launches} launches; {prof} on {smi}")
    del big
    registry.reset_launches()


def static_phase(mode: str, smi: str, args=None,
                 temps=STATIC_TEMPS, cfg=None) -> dict[str, int]:
    """The CLI's static batch (``--batch-slots 0``) with the compiled
    token loop and with ``--loop``, at each of STATIC_TEMPS: gated equal
    token for token, the same seed the same tokens with nothing new
    built, another step count the same two programs, graphs and eager
    equal, 252 MVM launches a forward and no attention kernel.  ``cfg``
    is passed on to the CLI (a cut of ``--arch``'s config).  Returns
    the launches of its first run."""
    import gc
    import torch
    from repro_torch.kernels import registry
    from repro_torch.launch import serve
    from repro_torch.serve import ServeEngine
    first = None
    base = STATIC_ARGS if args is None else args
    gen = int(base[base.index("--gen") + 1])
    for temp in temps:
        args = base + ["--pum-mode", mode, "--temperature", str(temp)]
        # the per-token loop first, and only its tokens kept: one model
        # on the card at a time
        registry.reset_launches()
        loop = serve.main(args + ["--loop"], cfg=cfg)
        torch.cuda.synchronize()
        loop_launches = dict(registry.LAUNCHES)
        loop_out, loop_s = loop["out"], loop["wall_s"]
        del loop
        gc.collect()
        registry.reset_launches()
        scan = serve.main(args, cfg=cfg)
        torch.cuda.synchronize()
        scan_launches = dict(registry.LAUNCHES)
        if first is None:
            first = scan_launches
        eng, prompt = scan["engine"], scan["prompt"]
        cfg = eng.cfg
        progs = eng.scan_programs()
        t0 = time.perf_counter()
        again = eng.generate(prompt, gen, temperature=temp, seed=0)
        torch.cuda.synchronize()
        steady_s = time.perf_counter() - t0
        eager_eng = ServeEngine(cfg, eng.params, max_len=eng.max_len,
                                device=eng.device, cuda_graphs=False)
        t0 = time.perf_counter()
        eager = eager_eng.generate(prompt, gen, temperature=temp, seed=0)
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
        other = eng.generate(prompt, gen, temperature=temp, seed=1)
        half = eng.generate(prompt, gen // 2, temperature=temp, seed=0)
        for launches in (scan_launches, loop_launches):
            launch_gate(mode, cfg, gen, 0, launches, paged=False)
        gates = {
            "scan equals the per-token loop": torch.equal(scan["out"],
                                                          loop_out),
            "the same seed gives the same tokens, nothing new built":
                torch.equal(again, scan["out"])
                and eng.scan_programs() == progs
                and progs == {(4, 64, float(temp)): 1},
            "another step count replays the same two programs": torch.equal(
                half, scan["out"][:, :64 + gen // 2])
                and eng.scan_programs() == progs
                and eng.graphs_captured()[0] == 2,
            "graphs and eager give the same tokens": torch.equal(
                eager, scan["out"]),
            "another seed gives other tokens only when sampling":
                torch.equal(other, scan["out"]) == (temp == 0),
        }
        failed = [k for k, ok in gates.items() if not ok]
        toks = scan["tokens"]
        log(f"static {cfg.name} {mode} t={temp}: batch 4 x 64 prompt "
            f"tokens, {gen} "
            f"tokens each; scan (build included) {scan['wall_s']:.3f} s = "
            f"{toks / scan['wall_s']:.1f} tok/s, loop {loop_s:.3f} s = "
            f"{toks / loop_s:.1f} tok/s; steady scan {steady_s:.3f} s = "
            f"{toks / steady_s:.1f} tok/s ({1e3 * steady_s / gen:.3f} ms a "
            f"token step), eager scan {eager_s:.3f} s; prefill and decode "
            f"graphs ({sum(scan_launches.values())} kernel launches in the "
            f"first run) built in {eng.graphs_captured()[1]:.2f} s; gates "
            f"failed: {failed} on {smi}")
        if failed:
            raise AssertionError(f"static {mode} t={temp}: {failed}")
        del scan, eng, eager_eng
        gc.collect()
    return first


def contig_cut():
    """Qwen2.5-3B's published config at ``CONTIG_LAYERS`` layers."""
    from repro_torch import configs
    return configs.get("qwen2.5-3b").replace(num_layers=CONTIG_LAYERS)


def contiguous_run(mode: str, smi: str) -> dict[str, int]:
    """Phase 9 in one mode, on Qwen2.5-3B cut to ``CONTIG_LAYERS``;
    returns the launches of its main paths (the CLI's contiguous run and
    its first static batch)."""
    import dataclasses
    import gc
    import torch
    from repro_torch.kernels import registry
    from repro_torch.launch import serve
    from repro_torch.serve import ContinuousBatchingScheduler
    torch.cuda.reset_peak_memory_stats()
    registry.reset_launches()
    res = serve.main(CONTIG_ARGS + ["--pum-mode", mode], cfg=contig_cut())
    torch.cuda.synchronize()
    launches = dict(registry.LAUNCHES)
    sched = res["scheduler"]
    cfg = sched.cfg
    tokens = tokens_of(res["completions"])
    if len(tokens) != 6 or any(len(t) != 16 for t in tokens.values()):
        raise AssertionError(f"contiguous {mode}: completions {tokens}")
    launch_gate(mode, cfg, sched.decode_steps,
                sched.prefill_chunks, launches, paged=False)
    progs = sched.step_programs()
    lengths = {len(r.prompt) for r in res["requests"]}
    steady = timed_run(sched, res["requests"])
    eager = timed_run(like(sched, cuda_graphs=False), res["requests"])
    # paged == contiguous where both run the same arithmetic: the torch
    # backend, monolithic prefill on both
    plain_contig = like(sched, cuda_graphs=True, kernel_backend="torch")
    plain_paged = ContinuousBatchingScheduler(
        cfg, sched.params, num_slots=sched.num_slots, max_len=sched.max_len,
        kv_block_size=16, chunked_prefill=False, kernel_backend="torch",
        device=sched.device)
    contig_t = tokens_of(plain_contig.run(res["requests"]))
    paged_t = tokens_of(plain_paged.run(res["requests"]))
    del plain_contig, plain_paged
    # phase 4's paged scheduler on the cuda backend, for its tokens and
    # its decode replay beside the contiguous one, in turns
    paged = ContinuousBatchingScheduler(
        cfg, sched.params, num_slots=sched.num_slots, max_len=sched.max_len,
        kv_block_size=16, chunked_prefill=True, device=sched.device)
    paged_cuda = tokens_of(paged.run(res["requests"]))
    replay = {"paged": [], "contiguous": []}
    for name in ("paged", "contiguous", "contiguous", "paged"):
        replay[name].append(step_device_ms(
            paged if name == "paged" else sched))
    del paged
    gates = {
        "one decode program, one prefill program a prompt length, each a "
        "graph": progs == {"decode": 1, "prefill": {n: 1 for n in lengths}}
        and res["graphs"] == 1 + len(lengths),
        "a second run builds nothing and gives the same tokens":
            sched.step_programs() == progs and steady["tokens"] == tokens,
        "graphs and eager give the same tokens and launches":
            eager["tokens"] == tokens
            and eager["launches"] == steady["launches"],
        "contiguous equals paged on the torch backend (monolithic "
        "prefill)": contig_t == paged_t,
    }
    for run in (steady, eager):
        launch_gate(mode, cfg, run["steps"], run["chunks"],
                    run["launches"], paged=False)
    failed = [k for k, ok in gates.items() if not ok]
    log(f"contiguous {mode}: 6 requests x 16 tokens, {steady['steps']} decode "
        f"steps + {steady['chunks']} prefills; launches {launches} (first "
        f"run); programs {progs}; decode_ms_per_step graphs / eager "
        f"{steady['decode_ms']:.3f} / {eager['decode_ms']:.3f}, tokens_per_s "
        f"{steady['tokens_per_s']:.2f} / {eager['tokens_per_s']:.2f}, "
        f"peak_mem_GB {steady['peak_gb']:.2f}; a decode replay, paged / "
        f"contiguous / contiguous / paged: {replay['paged'][0]:.4f} / "
        f"{replay['contiguous'][0]:.4f} / {replay['contiguous'][1]:.4f} / "
        f"{replay['paged'][1]:.4f} ms; first tokens differing from the "
        f"paged scheduler's on the cuda backend (K3) "
        f"{first_difference(tokens, paged_cuda)}, from the torch backend's "
        f"{first_difference(tokens, contig_t)}; "
        f"gates failed: {failed} on {smi}")
    if failed:
        raise AssertionError(f"contiguous {mode}: {failed}")
    reqs = [dataclasses.replace(r, temperature=t, seed=s) for r, t, s in
            zip(res["requests"], SAMPLED_TEMPS, SAMPLED_SEEDS)]
    contiguous_long(sched, reqs, mode, smi)
    del res, sched, eager
    gc.collect()
    torch.cuda.empty_cache()
    for k, v in static_phase(mode, smi, cfg=contig_cut()).items():
        launches[k] = launches.get(k, 0) + v
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def contiguous_phase(dev, gpu_name: str,
                     smi: str) -> tuple[dict[str, int], dict[str, dict]]:
    """Phase 9; returns each kernel's launches on its main paths and K1's
    and K2's rows at a prefill's M."""
    check_chunked_attention(dev, smi)
    rows = check_prefill_mvm(dev, gpu_name)
    launches: dict[str, int] = {}
    for mode in ("pum", "int8"):
        for k, v in contiguous_run(mode, smi).items():
            launches[k] = launches.get(k, 0) + v
    return launches, rows


# ---------------------------------------------------------------------------
# Phase 10: the xLSTM family (mLSTM and sLSTM mixers, per-slot state)
# ---------------------------------------------------------------------------

# phase 4's trace on xLSTM-350M: paged (blocks of 16, chunked prefill; it
# pages no KV, so a request takes 0 blocks) and from contiguous windows;
# and the static batch
XLSTM_ARGS = ["--arch", "xlstm-350m"] + SERVE_ARGS[2:]
XLSTM_CONTIG_ARGS = ["--arch", "xlstm-350m"] + CONTIG_ARGS[2:]
XLSTM_STATIC_ARGS = ["--arch", "xlstm-350m"] + STATIC_ARGS[2:]
# xLSTM-350M's projections by (K, N), counted over a forward pass of its
# 18 mLSTM (qkv; i and f, N = heads = 4; output gate; out) and 6 sLSTM
# (z, i, f, o; out) layers: 120
XLSTM_LAYERS = 24
XLSTM_MVM = {(1024, 6144): 18, (1024, 4): 36, (1024, 2048): 42,
             (2048, 1024): 24}
# phase 10 serves xLSTM-350M at full width cut to 8 of its 24 layers
# (6 mLSTM + 2 sLSTM, the same period of 4), so that the script stays
# well inside its time limit on a slow host (1092 s uncut there; 12
# layers until phase 16 came)
XLSTM_SERVE_LAYERS = 8


def xlstm_cut():
    from repro_torch import configs
    return configs.get("xlstm-350m").replace(num_layers=XLSTM_SERVE_LAYERS)

# Qwen2.5-3B's KV bytes a slot at the same window, for comparison: 36
# layers x K and V x 2 KV heads x 128 lanes x 2 bytes a position
QWEN_KV_BYTES_A_POSITION = 36 * 2 * 2 * 128 * 2


def check_xlstm_mvm(dev) -> list[dict]:
    """K1 and K2 at xLSTM-350M's shapes, N = 4 (mLSTM's gates, padded
    to 16 columns on the kernel) among them, at M in {1, 4, 16}."""
    return mvm_sweep(dev, XLSTM_MVM, XLSTM_LAYERS, "xLSTM-350M", MVM_ROWS)


def recurrent_snapshot(sched) -> list:
    from repro_torch.models import lm
    return [t.clone() for t in lm.recurrent_tensors(sched.cfg, sched.states)]


def advance_once(sched) -> bool:
    """The compiled step's rule on the recurrent steps: a fresh
    scheduler of ``sched``'s geometry with graphs, one without, the same
    two requests admitted and ticked; after every call (each program
    built at its first: warm-up, capture, replay) the recurrent state
    and the tokens of both are equal bit for bit."""
    import torch
    from repro_torch.serve import Request
    runs = {}
    for graphs in (True, False):
        s = like(sched, graphs)
        snaps, events = [], []
        for req in (Request(list(range(1, 21)), 3, rid=0),
                    Request(list(range(30, 37)), 3, temperature=0.7,
                            seed=5, rid=1)):
            s.start_request(req)
            snaps.append(recurrent_snapshot(s))
        for step in range(4):
            events += s.tick(step).events
            snaps.append(recurrent_snapshot(s))
        torch.cuda.synchronize()
        runs[graphs] = events, snaps
        del s
    (ev_g, sn_g), (ev_e, sn_e) = runs[True], runs[False]
    return ev_g == ev_e and len(ev_g) > 0 and all(
        torch.equal(a, b) for x, y in zip(sn_g, sn_e) for a, b in zip(x, y))


def nonfinite(sched) -> list[str]:
    """Where ``sched``'s recurrent states (by layer, leaf and row) or the
    last logits of any of its steps (by row) are not finite.  Each
    graph keeps its logits outside the pool the graphs share, so a
    step's logits hold until its own next call (``CompiledStep``)."""
    import torch
    from repro_torch.models import transformer

    def rows(t):
        bad = ~torch.isfinite(t.reshape(t.shape[0], -1)).all(dim=1)
        return bad.nonzero().flatten().tolist()

    out = []
    for j, st in enumerate(sched.states):
        if transformer.layer_kinds(sched.cfg, j)[0] == "attn":
            continue
        out += [f"layer {j} {name} rows {r}" for name, t in st.items()
                if (r := rows(t))]
    out += [f"step {key} logits rows {r}"
            for key, t in sched.last_logits().items() if (r := rows(t))]
    return out


def recurrence_ms(cfg, slots: int) -> float:
    """Device time of the recurrences of one decode step alone: every
    mLSTM and sLSTM layer's cell at ``slots`` rows on random f32 inputs
    (``models/xlstm.py``'s ``_mlstm_step`` and ``_slstm_step``)."""
    import torch
    from repro_torch.models import transformer, xlstm
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(4)
    inner, heads, hd = xlstm._dims(cfg)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    kinds = [transformer.layer_kinds(cfg, j)[0]
             for j in range(cfg.num_layers)]
    m_state = (rnd(slots, heads, hd, hd), rnd(slots, heads, hd).abs(),
               rnd(slots, heads))
    m_in = (rnd(slots, heads, hd), rnd(slots, heads, hd),
            rnd(slots, heads, hd), rnd(slots, heads), rnd(slots, heads))
    s_state = (rnd(slots, inner), rnd(slots, inner).abs(), rnd(slots, inner))
    s_in = tuple(rnd(slots, inner) for _ in range(4))

    def cells():
        for kind in kinds:
            if kind == "mlstm":
                xlstm._mlstm_step(m_state, *m_in)
            else:
                xlstm._slstm_step(s_state, s_in)
    return device_ms(cells, iters=2)


def xlstm_measure(sched, contig, smi: str) -> None:
    """Phase 10's numbers in one mode: a decode replay's device time and
    its split under the profiler, the recurrences alone, a 64-token
    prompt's prefill, and the state bytes a slot."""
    import numpy as np
    from repro_torch.models import lm
    from repro_torch.serve import prng
    mode, cfg = sched.cfg.pum.mode, sched.cfg
    replay_ms = step_device_ms(sched)
    prog = sched.program("decode")
    _, by_name = kernel_times(prog.launch)
    if by_name:
        total = sum(by_name.values()) / 1e3
        mvm = sum(us for name, us in by_name.items()
                  if "bitslice_mvm_kernel" in name) / 1e3
        prof = (f"under the profiler {total:.3f} ms of kernels, the MVM "
                f"kernel {mvm:.3f} ms ({100 * mvm / total:.1f} %); top: "
                f"{top_kernels(by_name, 5)}")
    else:
        prof = "the profiler saw no device time (not measured)"
    rec_ms = recurrence_ms(cfg, sched.num_slots)
    # a 64-token prompt's admission prefill into the idle slot 0
    prompt = list(range(1, 65))
    pre = contig.program(64, [prompt], 0, prng.prng_key(1).numpy(),
                         np.float32(0.0).view(np.int32))
    pre.stage([prompt], 0, prng.prng_key(1).numpy(),
              np.float32(0.0).view(np.int32))
    prefill_ms = event_ms(pre.launch, reps=3)
    state_bytes = sum(t.nbytes for t in lm.recurrent_tensors(
        cfg, sched.states)) / sched.num_slots
    qwen_bytes = QWEN_KV_BYTES_A_POSITION * sched.max_len
    log(f"xlstm {mode} decode step ({sched.num_slots} slots): a graph "
        f"replay {replay_ms:.4f} ms of device time; {prof}; the "
        f"recurrences alone (18 mLSTM + 6 sLSTM cells at {sched.num_slots} "
        f"rows) {rec_ms:.4f} ms = {100 * rec_ms / replay_ms:.1f} % of the "
        f"replay on {smi}")
    log(f"xlstm {mode} prefill of a 64-token prompt (contiguous admission, "
        f"one replay): {prefill_ms:.3f} ms of device time, "
        f"{dict(pre.launches)} launches; recurrent state "
        f"{state_bytes / 2**20:.2f} MiB a slot against Qwen2.5-3B's KV "
        f"{qwen_bytes / 2**20:.2f} MiB a slot at the same window "
        f"({sched.max_len} positions) on {smi}")


def xlstm_run(mode: str, smi: str) -> dict[str, int]:
    """Phase 10 in one mode: the CLI paged and contiguous (its main
    paths, whose launches are returned with the static batch's), then on
    their schedulers phase 8's sampled requests, with every gate."""
    import dataclasses
    import gc
    import torch
    from repro_torch.kernels import registry
    from repro_torch.launch import serve
    from repro_torch.serve import oracle_completion
    t0 = time.perf_counter()
    launches: dict[str, int] = {}
    runs = {}
    for layout, args in (("paged", XLSTM_ARGS),
                         ("contiguous", XLSTM_CONTIG_ARGS)):
        registry.reset_launches()
        res = serve.main(args + ["--pum-mode", mode], cfg=xlstm_cut())
        torch.cuda.synchronize()
        counts = dict(registry.LAUNCHES)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        sched = res["scheduler"]
        launch_gate(mode, sched.cfg, sched.decode_steps,
                    sched.prefill_chunks, counts, paged=False)
        progs = sched.step_programs()
        built = [progs["decode"], *next(v for k, v in progs.items()
                                        if k != "decode").values()]
        comps = res["completions"]
        if len(comps) != 6 or any(len(c.tokens) != 16
                                  for c in comps.values()) \
                or any(n != 1 for n in built) \
                or res["graphs"] != len(built):
            raise AssertionError(f"xlstm {mode} {layout}: completions "
                                 f"{tokens_of(comps)}, programs {progs}, "
                                 f"{res['graphs']} graphs")
        runs[layout] = res
        log(f"xlstm {mode} {layout}: {sched.cfg.name} {sched.cfg.num_layers} "
            f"layers d_model {sched.cfg.d_model}, 6 requests x 16 tokens, "
            f"{sched.decode_steps} decode steps + {sched.prefill_chunks} "
            f"prefill {'chunks' if sched.paged else 'prompts'}; launches "
            f"{counts} (replays counted); programs {progs}, {res['graphs']} "
            f"graphs built in {res['build_s']:.2f} s")
    paged, contig = runs["paged"]["scheduler"], runs["contiguous"]["scheduler"]
    greedy = tokens_of(runs["paged"]["completions"])
    reqs = [dataclasses.replace(r, temperature=t, seed=s) for r, t, s in
            zip(runs["paged"]["requests"], SAMPLED_TEMPS, SAMPLED_SEEDS)]
    progs = {k: s.step_programs() for k, s in (("paged", paged),
                                               ("contiguous", contig))}
    again = timed_run(paged, runs["paged"]["requests"])
    t0 = time.perf_counter()
    sampled = {"paged": timed_run(paged, reqs),
               "contiguous": timed_run(contig, reqs)}
    eager = {"paged": timed_run(like(paged, cuda_graphs=False), reqs),
             "contiguous": timed_run(like(contig, cuda_graphs=False), reqs)}
    t1 = time.perf_counter()
    solo = {r.rid: oracle_completion(paged.engine, r) for r in reqs}
    solo_s = time.perf_counter() - t1
    sampled_s = time.perf_counter() - t0
    rule = {k: advance_once(s) for k, s in (("paged", paged),
                                            ("contiguous", contig))}
    bad = {k: nonfinite(s) for k, s in (("paged", paged),
                                        ("contiguous", contig))}
    toks = sampled["paged"]["tokens"]
    gates = {
        "each completion equals its request alone through generate_loop "
        "(cuda backend), paged": toks == solo,
        "and contiguous": sampled["contiguous"]["tokens"] == solo,
        "the greedy CLI runs give the same tokens paged and contiguous":
            greedy == tokens_of(runs["contiguous"]["completions"]),
        "a second run builds nothing and gives the same tokens":
            again["tokens"] == greedy
            and paged.step_programs() == progs["paged"],
        "one decode program for greedy and sampled rows, nothing new "
        "built": all(s.step_programs() == progs[k] and progs[k]["decode"]
                     == 1 for k, s in (("paged", paged),
                                       ("contiguous", contig))),
        "graphs and eager give the same tokens and launches": all(
            eager[k]["tokens"] == sampled[k]["tokens"]
            and eager[k]["launches"] == sampled[k]["launches"]
            for k in sampled),
        "a recurrent step built and called once leaves one eager call's "
        "state (paged chunk and decode, contiguous prefill and decode)":
            all(rule.values()),
        "states and logits finite": not bad["paged"]
            and not bad["contiguous"],
    }
    for run in (again, *sampled.values(), *eager.values()):
        launch_gate(mode, paged.cfg, run["steps"], run["chunks"],
                    run["launches"], paged=False)
    failed = [k for k, ok in gates.items() if not ok]
    log(f"xlstm {mode}: 6 requests at temperatures {list(SAMPLED_TEMPS)}, "
        f"seeds {list(SAMPLED_SEEDS)}; paged {sampled['paged']['steps']} "
        f"decode steps + {sampled['paged']['chunks']} chunks, launches "
        f"{sampled['paged']['launches']}; the sampled trace's runs "
        f"{sampled_s:.1f} s, of them the solo runs {solo_s:.1f} s; first "
        f"differences from the solo runs paged "
        f"{first_difference(toks, solo)}, contiguous "
        f"{first_difference(sampled['contiguous']['tokens'], solo)}; "
        f"non-finite {bad}; gates failed: {failed}")
    for k in sampled:
        log(f"xlstm {mode} {k}: decode_ms_per_step graphs / eager "
            f"{sampled[k]['decode_ms']:.3f} / {eager[k]['decode_ms']:.3f}, "
            f"tokens_per_s {sampled[k]['tokens_per_s']:.2f} / "
            f"{eager[k]['tokens_per_s']:.2f}, peak_mem_GB "
            f"{sampled[k]['peak_gb']:.2f} on {smi}")
    if failed:
        raise AssertionError(f"xlstm {mode}: {failed}")
    if mode == "pum":           # speculative decoding: mLSTM and sLSTM rows
        spec = spec_check("xlstm-350m", paged, runs["paged"]["requests"],
                          greedy, smi)
        for k, v in spec["launches"].items():
            launches[k] = launches.get(k, 0) + v
    backend_parity(paged)
    xlstm_measure(paged, contig, smi)
    cfg, params = paged.cfg, paged.params
    del runs, paged, contig, eager
    gc.collect()
    torch.cuda.empty_cache()
    if mode == "pum":           # the prefix cache: snapshots, no blocks
        for check in (prefix_check("xlstm-350m", "xlstm", cfg, params, smi),
                      long_snapshots(cfg, params, smi)):
            for k, v in check.items():
                launches[k] = launches.get(k, 0) + v
    del params
    for k, v in static_phase(mode, smi, XLSTM_STATIC_ARGS,
                             temps=(0.0,), cfg=xlstm_cut()).items():
        launches[k] = launches.get(k, 0) + v
    gc.collect()
    torch.cuda.empty_cache()
    log(f"xlstm {mode}: phase in {time.perf_counter() - t0:.1f} s")
    return launches


def xlstm_phase(smi: str) -> dict[str, int]:
    """Phase 10; returns each kernel's launches on its main paths."""
    launches: dict[str, int] = {}
    for mode in ("pum", "int8"):
        for k, v in xlstm_run(mode, smi).items():
            launches[k] = launches.get(k, 0) + v
    return launches


def xlstm_rows(cases: list[dict]) -> dict[str, list[dict]]:
    """K1's and K2's rows at xLSTM-350M's shapes, for the kernels line."""
    return {name: [c[kern] for c in cases]
            for name, kern in (("bitslice_mvm_scaled", "K1"),
                               ("bitslice_mvm", "K2"))}


# ---------------------------------------------------------------------------
# Phase 11: the MoE family (top-k routed experts, capacity-bounded dispatch)
# ---------------------------------------------------------------------------

# phase 4's trace on OLMoE-1B-7B: paged (blocks of 16, chunked prefill)
# and from contiguous windows; the static batch; granite-moe-1b-a400m
# paged
OLMOE_ARGS = ["--arch", "olmoe-1b-7b"] + SERVE_ARGS[2:]
OLMOE_CONTIG_ARGS = ["--arch", "olmoe-1b-7b"] + CONTIG_ARGS[2:]
OLMOE_STATIC_ARGS = ["--arch", "olmoe-1b-7b"] + STATIC_ARGS[2:]
GRANITE_ARGS = ["--arch", "granite-moe-1b-a400m"] + SERVE_ARGS[2:]
# OLMoE-1B-7B's projections on the MVM kernels: q, k, v and o of its 16
# MHA layers, all 2048 x 2048 (the router and the experts are float
# products): 64 a forward pass
OLMOE_LAYERS = 16
OLMOE_MVM = {(2048, 2048): 64}
# device kernels of a decode replay by name, for its split under the
# profiler; "float GEMMs" holds the expert bmms, and with them the f32
# router and lm head
KERNEL_CLASSES = [
    ("K1/K2", ("bitslice_mvm",)),
    ("K3", ("paged_attention", "store_kernel")),
    ("expert cast (copies)", ("copy_kernel",)),
    ("float GEMMs", ("gemm", "gemv", "xmma", "cutlass", "cublas", "nvjet")),
    ("sort and ranks", ("sort", "radix", "searchsorted")),
    ("gathers and scatters", ("index", "scatter", "gather")),
]


def moe_layers(cfg) -> int:
    """The layers of ``cfg`` whose FFN is routed: every layer of OLMoE's
    stack, every other one of Jamba's (one ``moe.route`` call each in a
    forward pass)."""
    from repro_torch.models import transformer
    return sum(transformer.layer_kinds(cfg, j)[1] == "moe"
               for j in range(cfg.num_layers))


def no_drop(cfg):
    """``cfg`` at capacity factor E / k: an expert's capacity is then
    every row of a call, and no assignment is dropped."""
    import dataclasses
    return cfg.replace(moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))


class routing:
    """Within ``with``, every ``moe.route`` call (one a layer of each
    forward pass, as ``moe_ffn`` makes it) is recorded in ``calls``: its
    router probabilities [T, E], the top-k experts it chose itself
    [T, k], its layer, its capacity and what its rows hold (``rows``:
    (request id, position), or None for a row that holds no request).
    ``label`` names the rows of the calls that follow; a scheduler
    given as ``sched`` names its own (its prompt dispatches and its
    decode steps, whose rows are its slots).  ``force(n, layer, rows,
    experts)`` may return other top-k experts for call ``n``, which it
    then routes to, gated by its own probabilities normalised as
    ``route`` does: a run can hold another run's routing.  Eager runs
    only: a graph replay runs no Python."""

    def __init__(self, layers: int, sched=None, force=None):
        self.layers, self.sched, self.force = layers, sched, force
        self.rows, self._admitting = None, None

    def label(self, rows) -> None:
        self.rows = rows

    def _slot_rows(self) -> list:
        s = self.sched
        return [(s._slot_req[i].rid, len(s._slot_req[i].prompt)
                 + len(s._slot_toks[i]) - 1) if s._active[i] else None
                for i in range(s.num_slots)]

    def __enter__(self):
        from repro_torch.models import moe
        self.calls, self.inner = [], moe.route

        def route(p, xf, cfg):
            logits, probs, vals, idx = self.inner(p, xf, cfg)
            n, layer = len(self.calls), len(self.calls) % self.layers
            decode = self.rows is None and self.sched is not None
            rows = self._slot_rows() if decode else self.rows
            self.calls.append(dict(probs=probs, idx=idx, rows=rows,
                                   layer=layer, decode=decode,
                                   cap=moe.capacity(xf.shape[0], cfg)))
            held = None if self.force is None else self.force(
                n, layer, rows, idx)
            if held is None:
                return logits, probs, vals, idx
            sel = probs.gather(-1, held)
            return logits, probs, sel / sel.sum(-1, keepdim=True), held

        moe.route = route
        s = self.sched
        if s is not None:
            dispatch, admit = s._dispatch, s._admit

            def labelled(key, *values):
                # a paged chunk: (tokens, start, table row, slot, ...); a
                # contiguous admission: the whole prompt from position 0
                rid, start = ((s._prefills[int(values[3])].req.rid,
                               int(values[1])) if s.paged
                              else (self._admitting, 0))
                self.rows = [(rid, start + j) for j in range(key)]
                try:
                    return dispatch(key, *values)
                finally:
                    self.rows = None

            def admitting(slot, req, step):
                self._admitting = req.rid
                return admit(slot, req, step)

            s._dispatch, s._admit = labelled, admitting
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.route = self.inner
        if self.sched is not None:
            del self.sched._dispatch, self.sched._admit


def k_gaps(probs, k: int):
    """Each row's gap between its k-th and (k+1)-th largest probability:
    how far its router sits from choosing another expert."""
    import numpy as np
    top = -np.sort(-np.asarray(probs), axis=-1)
    return top[..., k - 1] - top[..., k]


def by_position(calls: list) -> dict:
    """The labelled rows of recorded calls, on the host: {(request id,
    position): {layer: (probabilities, experts)}}."""
    out: dict = {}
    for c in calls:
        if c["rows"] is None:
            continue
        probs, idx = c["probs"].cpu().numpy(), c["idx"].cpu().numpy()
        for r, lab in enumerate(c["rows"]):
            if lab is not None:
                out.setdefault(lab, {})[c["layer"]] = (probs[r], idx[r])
    return out


def held_to(ref: dict):
    """A ``routing`` force that routes each labelled row as ``ref`` (a
    ``by_position`` map) routed its request's position at that layer."""
    import numpy as np
    import torch

    def force(n, layer, rows, idx):
        hit = [(r, ref[lab][layer][1]) for r, lab in enumerate(rows or [])
               if lab in ref]
        if not hit:
            return None
        out = idx.clone()
        out[torch.tensor([r for r, _ in hit], device=idx.device)] = \
            torch.from_numpy(np.stack([e for _, e in hit])).to(out)
        return out

    return force


def swap_gap(p_ref, e_ref, e_got) -> float:
    """Where two top-k choices differ: the gap in the reference's
    probabilities between its expert and the other run's at the first
    rank where they differ (>= 0: the reference ranked its own first)."""
    import numpy as np
    j = int(np.nonzero(e_ref != e_got)[0][0])
    return float(p_ref[e_ref[j]] - p_ref[e_got[j]])


def moe_backend_parity(sched) -> tuple[float, float]:
    """``backend_parity`` for an MoE model, with the routing held: one
    chunk and one decode step on the ``cuda`` backend (run a), on the
    ``torch`` backend (b) and on ``cuda`` with layer 0's attention input
    moved by one bf16 ulp on every other channel (c), b and c routed as
    a routes (``routing(force=...)``: the same experts, gated by their
    own probabilities).  With the routing held the runs differ only by
    rounding, and these must hold: b's logits within c's change of a's
    (the bound) and b's greedy tokens a's; b's router probabilities
    within c's change of a's (the router's one-ulp sensitivity); and
    wherever b's router would itself choose other experts than a's, a's
    probabilities of the two experts within that sensitivity (a
    near-tie, counted).  Returns (the bound, the sensitivity): how far
    one ulp moves the logits and the router with the routing held."""
    import numpy as np
    import torch
    cfg, params = sched.cfg, sched.params
    layers, k = moe_layers(cfg), cfg.moe.top_k
    with routing(layers) as ra:
        a = chunk_and_step(sched, params, "cuda")

    def held(n, layer, rows, idx):
        return ra.calls[n]["idx"]

    with routing(layers, force=held) as rb:
        b = chunk_and_step(sched, params, "torch")
    with routing(layers, force=held) as rc:
        c = chunk_and_step(sched, nudged(params), "cuda")
    if not all(bool(torch.isfinite(t).all()) for t in (a, b, c)):
        raise AssertionError("non-finite logits")
    if not len(ra.calls) == len(rb.calls) == len(rc.calls) == 2 * layers:
        raise AssertionError("the moe calls were not all recorded")
    err = (a - b).abs().max().item()
    bound = (c - a).abs().max().item()
    same = bool((a.argmax(-1) == b.argmax(-1)).all())
    top2 = torch.topk(a, 2, dim=-1).values
    margins = (top2[..., 0] - top2[..., 1]).flatten().tolist()

    def host(calls, key):
        return [x[key].cpu().numpy() for x in calls]

    pa, pb, pc = (host(r.calls, "probs") for r in (ra, rb, rc))
    ea, eb = host(ra.calls, "idx"), host(rb.calls, "idx")
    drift = max(float(np.abs(x - y).max()) for x, y in zip(pb, pa))
    sens = max(float(np.abs(x - y).max()) for x, y in zip(pc, pa))
    swaps = [(n, swap_gap(pa[n][r], ea[n][r], eb[n][r]))
             for n in range(len(ea))
             for r in np.nonzero((ea[n] != eb[n]).any(-1))[0]]
    gaps = np.concatenate([k_gaps(x, k) for x in pa])
    log(f"backend parity {cfg.name} {cfg.pum.mode} (capacity factor "
        f"{cfg.moe.capacity_factor}), routing held to the cuda run's: "
        f"chunk + decode logits max|cuda - torch| = {err:.4g}, bound "
        f"(one-ulp nudge of layer 0) = {bound:.4g}, max|logit| = "
        f"{b.abs().max().item():.4g}, the cuda run's top-2 margins "
        f"{[round(m, 4) for m in margins]}, greedy tokens equal: {same}; "
        f"router probabilities max|cuda - torch| = {drift:.3g}, the nudge's "
        f"(the router's one-ulp sensitivity) {sens:.3g}; {len(swaps)} rows "
        f"of {sum(len(x) for x in ea)} over {len(ea)} calls where the torch "
        f"router would choose otherwise, (call, gap) "
        f"{[(n, f'{g:.3g}') for n, g in swaps]}; the cuda run's k-th to "
        f"(k+1)-th probability gaps: median {float(np.median(gaps)):.3g}, "
        f"{100 * float((gaps <= sens).mean()):.1f} % within the "
        f"sensitivity")
    if bound == 0.0 or sens == 0.0:
        raise AssertionError("the nudge did not reach the logits or the "
                             "router")
    if err > bound or not same:
        raise AssertionError(f"backend parity failed: {err} > {bound} or "
                             f"greedy differs, routing held")
    if drift > sens:
        raise AssertionError(f"router probabilities part by {drift}, past "
                             f"the one-ulp sensitivity {sens}")
    if any(g > sens for _, g in swaps):
        raise AssertionError(f"a routing choice that differs past the "
                             f"one-ulp sensitivity {sens}: {swaps}")
    return bound, sens


def solo_routing(eng, requests, solo: dict) -> tuple[dict, dict]:
    """Each request alone on ``eng``, its prefill then one decode step a
    token along its ``solo`` tokens, as ``generate_loop`` ran it: its
    routing by position (``by_position``) and its top-2 logit margin
    before each token.  Its greedy tokens must be ``solo``'s."""
    import torch
    dev, layers = eng.device, moe_layers(eng.cfg)
    margins = {}
    with routing(layers) as rec, torch.inference_mode():
        for r in requests:
            prompt, toks = list(r.prompt), solo[r.rid]
            rec.label([(r.rid, j) for j in range(len(prompt))])
            states, lg = eng.prefill(torch.tensor([prompt],
                                                  dtype=torch.int32,
                                                  device=dev))
            out = [lg]
            for i, tok in enumerate(toks[:-1]):
                rec.label([(r.rid, len(prompt) + i)])
                lg, states = eng.decode(states, torch.tensor(
                    [[tok]], dtype=torch.int32, device=dev),
                    len(prompt) + i)
                out.append(lg)
            lg = torch.cat(out, dim=1).float()[0]
            if lg.argmax(-1).tolist() != toks:
                raise AssertionError(f"request {r.rid} alone: greedy "
                                     f"{lg.argmax(-1).tolist()} != {toks}")
            top2 = torch.topk(lg, 2, dim=-1).values
            margins[r.rid] = (top2[:, 0] - top2[:, 1]).tolist()
    return by_position(rec.calls), margins


def no_drop_runs(sched, requests, graph_tokens: dict, solo: dict, ref: dict,
                 margins: dict, tie: float, sens: float
                 ) -> tuple[dict, list[str]]:
    """At a no-drop capacity factor each row is computed alone, up to the
    rounding of the products whose row count is the capacity.  An eager
    copy of ``sched`` serves ``requests`` (its tokens must be the graph
    run's, ``graph_tokens``) and another with every row routed as the
    request alone routed it (``ref``); against the requests alone
    (``solo``), with the routing held, the router probabilities must
    stay within the one-ulp sensitivity ``sens``, every choice the
    router would make otherwise must sit at a near-tie (a gap within
    ``sens``) and a first token difference at a near-tie of the logits
    (the solo top-2 margin within ``tie``, the one-ulp bound); a first
    difference of the run on its own routing must be the held run's, or
    follow a routing choice that differs.  Returns the eager tokens and
    the failures."""
    import numpy as np
    layers = moe_layers(sched.cfg)
    free = like(sched, cuda_graphs=False)
    with routing(layers, sched=free):
        own = tokens_of(free.run(requests))
    held = like(sched, cuda_graphs=False)
    with routing(layers, sched=held, force=held_to(ref)) as rec:
        kept = tokens_of(held.run(requests))
    got = by_position(rec.calls)
    failed, rows = [], {}
    for r in requests:
        p, n, want = len(r.prompt), len(solo[r.rid]), solo[r.rid]
        i_own = first_difference({0: own[r.rid]}, {0: want})[0]
        i_held = first_difference({0: kept[r.rid]}, {0: want})[0]
        drift, swaps = 0.0, []
        for pos in range(p + (n - 1 if i_held is None else i_held)):
            for layer, (pr, er) in ref[(r.rid, pos)].items():
                pg, eg = got[(r.rid, pos)][layer]
                drift = max(drift, float(np.abs(pg - pr).max()))
                if (eg != er).any():
                    swaps.append((pos, layer, swap_gap(pr, er, eg)))
        first = min(n if i_own is None else i_own,
                    n if i_held is None else i_held)
        rows[r.rid] = dict(own=i_own, held=i_held, drift=float(
            f"{drift:.3g}"), swaps=[(pos, layer, float(f"{g:.3g}"))
                                    for pos, layer, g in swaps[:3]],
            n_swaps=len(swaps), margin=None if i_held is None
            else round(margins[r.rid][i_held], 4))
        if drift > sens:
            failed.append(f"request {r.rid}: router probabilities part by "
                          f"{drift} > {sens}")
        if any(g > sens for _, _, g in swaps):
            failed.append(f"request {r.rid}: a routing choice past a "
                          f"near-tie {swaps}")
        if i_held is not None and margins[r.rid][i_held] > tie:
            failed.append(f"request {r.rid}: routing held, first "
                          f"difference at token {i_held} past a near-tie")
        if i_own != i_held and not any(pos < p + first
                                       for pos, _, _ in swaps):
            failed.append(f"request {r.rid}: on its own routing it first "
                          f"differs at {i_own}, held at {i_held}, with no "
                          f"routing choice differing before")
    if own != graph_tokens:
        failed.append("eager tokens differ from the graph run's")
    return dict(own=own, held=kept, rows=rows), failed


def moe_measure(sched, contig, requests, smi: str) -> dict[str, float]:
    """Phase 11's numbers in one mode: a decode replay's device time and
    its split under the profiler; the expert cast, the expert products
    and the rest of one layer's ``moe_ffn`` timed alone; a 64-token
    prompt's prefill; the share of assignments dropped a decode step.
    Returns the replay's and the prefill's device ms."""
    import numpy as np
    import torch
    from repro_torch.models import moe
    from repro_torch.serve import prng
    mode, cfg, params = sched.cfg.pum.mode, sched.cfg, sched.params
    dev, b = sched.device, sched.num_slots
    replay_ms = step_device_ms(sched)
    _, by_name = kernel_times(sched.program("decode").launch)
    if by_name:
        total = sum(by_name.values()) / 1e3
        split = {name: 0.0 for name, _ in KERNEL_CLASSES}
        split["other"] = 0.0
        for kname, us in by_name.items():
            cls = next((name for name, keys in KERNEL_CLASSES
                        if any(k in kname for k in keys)), "other")
            split[cls] += us / 1e3
        prof = (f"under the profiler {total:.3f} ms of kernels: " + ", ".join(
            f"{k} {v:.3f} ms ({100 * v / total:.1f} %)"
            for k, v in split.items()) + f"; top: {top_kernels(by_name, 5)}")
    else:
        prof = "the profiler saw no device time (not measured)"
    blocks = [blk["moe"] for blk in params["blocks"] if "moe" in blk]
    experts = [blk[n] for blk in blocks
               for n in ("experts_wg", "experts_wu", "experts_wd")]

    def cast_all():
        for t in experts:
            t.to(torch.bfloat16)

    cast_ms = event_ms(cast_all, reps=3)
    blk = blocks[0]
    w = [blk[n].to(torch.bfloat16) for n in ("experts_wg", "experts_wu",
                                             "experts_wd")]
    g = torch.Generator(device=dev).manual_seed(5)
    e, d = cfg.moe.num_experts, cfg.d_model
    buf = torch.randn((e, 1, d), generator=g, device=dev).to(torch.bfloat16)

    def products():
        for _ in blocks:
            act = torch.nn.functional.silu(torch.bmm(buf, w[0])) * \
                torch.bmm(buf, w[1])
            torch.bmm(act, w[2])

    bmm_ms = event_ms(products, reps=3)
    del w
    x = torch.randn((b, 1, d), generator=g, device=dev).to(torch.bfloat16)
    with torch.inference_mode():
        layer_ms = event_ms(lambda: moe.moe_ffn(blk, x, cfg, aux=False),
                            reps=5)
    rest_ms = layer_ms - (cast_ms + bmm_ms) / len(blocks)
    nbytes = sum(t.numel() for t in experts) * (4 + 2)
    log(f"moe {cfg.name} {mode} decode step ({b} slots): a graph replay "
        f"{replay_ms:.4f} ms of device time; {prof} on {smi}")
    log(f"moe {cfg.name} {mode} alone: the per-call expert cast of all "
        f"{len(blocks)} MoE layers {cast_ms:.3f} ms ({nbytes / 1e9:.1f} GB "
        f"read and written, bound {nbytes / peaks(smi)[0] * 1e3:.3f} ms); "
        f"the expert products at capacity 1 (3 bmms a layer over all {e} "
        f"experts) {bmm_ms:.3f} ms; one layer's moe_ffn {layer_ms:.3f} ms, "
        f"of it the router, sort, ranks, gathers and combine "
        f"{rest_ms:.3f} ms (the layer less its cast and products) on {smi}")
    prompt = list(range(1, 65))
    pre = contig.program(64, [prompt], 0, prng.prng_key(1).numpy(),
                         np.float32(0.0).view(np.int32))
    pre.stage([prompt], 0, prng.prng_key(1).numpy(),
              np.float32(0.0).view(np.int32))
    prefill_ms = event_ms(pre.launch, reps=3)
    shares = dropped_shares(sched, requests)
    log(f"moe {cfg.name} {mode}: a 64-token prefill (contiguous admission, "
        f"one replay) {prefill_ms:.3f} ms of device time, "
        f"{dict(pre.launches)} launches; decode capacity "
        f"{moe.capacity(b, cfg)} an expert, assignments dropped a decode "
        f"step (over {len(shares)} layer calls of the trace): mean "
        f"{100 * float(np.mean(shares)):.1f} %, max "
        f"{100 * max(shares):.1f} % on {smi}")
    return {"replay_ms": replay_ms, "prefill_ms": prefill_ms}


def dropped_shares(sched, requests) -> list[float]:
    """The share of assignments dropped at each MoE layer of each decode
    step of ``requests`` served by an eager copy of ``sched``, idle
    rows' assignments included (they take capacity too)."""
    from repro_torch.models import moe
    eager = like(sched, cuda_graphs=False)
    with routing(moe_layers(sched.cfg), sched=eager) as rec:
        eager.run(requests)
    e = sched.cfg.moe.num_experts
    return [float((moe.dispatch_slots(c["idx"], e) >= c["cap"]).float()
                  .mean()) for c in rec.calls if c["decode"]]


def moe_run(mode: str, smi: str) -> dict[str, int]:
    """Phase 11 in one mode: the CLI paged and contiguous (its main
    paths, whose launches are returned with the static batch's), then
    the gates at the config's own capacity factor and at E / k."""
    import gc
    import torch
    from repro_torch.kernels import registry
    from repro_torch.launch import serve
    from repro_torch.serve import ContinuousBatchingScheduler
    t0 = time.perf_counter()
    launches: dict[str, int] = {}
    runs = {}
    for layout, args in (("paged", OLMOE_ARGS),
                         ("contiguous", OLMOE_CONTIG_ARGS)):
        registry.reset_launches()
        res = serve.main(args + ["--pum-mode", mode])
        torch.cuda.synchronize()
        counts = dict(registry.LAUNCHES)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        sched = res["scheduler"]
        launch_gate(mode, sched.cfg, sched.decode_steps,
                    sched.prefill_chunks, counts, paged=sched.paged)
        progs = sched.step_programs()
        built = [progs["decode"], *next(v for k, v in progs.items()
                                        if k != "decode").values()]
        comps = res["completions"]
        vp = sched.params["embed"].shape[0]
        if len(comps) != 6 or any(
                len(c.tokens) != 16 or not all(0 <= t < vp for t in c.tokens)
                for c in comps.values()) \
                or any(n != 1 for n in built) \
                or res["graphs"] != len(built):
            raise AssertionError(f"moe {mode} {layout}: completions "
                                 f"{tokens_of(comps)}, programs {progs}, "
                                 f"{res['graphs']} graphs")
        log(f"moe {mode} {layout}: {sched.cfg.name} {sched.cfg.num_layers} "
            f"layers d_model {sched.cfg.d_model}, {sched.cfg.moe.num_experts} "
            f"experts top-{sched.cfg.moe.top_k}, capacity factor "
            f"{sched.cfg.moe.capacity_factor}; 6 requests x 16 tokens, "
            f"{sched.decode_steps} decode steps + {sched.prefill_chunks} "
            f"prefill {'chunks' if sched.paged else 'prompts'}; launches "
            f"{counts} (replays counted); programs {progs}, {res['graphs']} "
            f"graphs built in {res['build_s']:.2f} s; peak_mem_GB "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
        runs[layout] = dict(tokens=tokens_of(comps),
                            requests=res["requests"])
        if layout == "paged":
            runs[layout]["sched"] = sched
            del res, sched
            continue
        # one model on the card: the contiguous scheduler again on the
        # paged run's weights (the same seed, so the same weights)
        del res, sched, comps
        gc.collect()
        torch.cuda.empty_cache()
        p = runs["paged"]["sched"]
        runs[layout]["sched"] = ContinuousBatchingScheduler(
            p.cfg, p.params, num_slots=p.num_slots, max_len=p.max_len,
            kv_block_size=0, device=p.device)
    reqs = runs["paged"]["requests"]
    gates, again, eager = {}, {}, {}
    for layout, run in runs.items():
        sched = run["sched"]
        # the trace again from the state a fresh scheduler starts in (the
        # idle rows take capacity, so a run depends on what the last one
        # left in them)
        sched._reset()
        again[layout] = timed_run(sched, reqs)
        progs = sched.step_programs()
        sched._reset()
        twice = timed_run(sched, reqs)
        eager[layout] = timed_run(like(sched, cuda_graphs=False), reqs)
        gates[f"{layout}: the same trace from a fresh state gives the CLI's "
              f"tokens, twice, building nothing after its first"] = (
            again[layout]["tokens"] == run["tokens"] == twice["tokens"]
            and sched.step_programs() == progs and progs["decode"] == 1)
        gates[f"{layout}: graphs and eager give the same tokens and "
              f"launches"] = (eager[layout]["tokens"] == run["tokens"]
                              and eager[layout]["launches"]
                              == twice["launches"])
        for r in (again[layout], twice, eager[layout]):
            launch_gate(mode, sched.cfg, r["steps"], r["chunks"],
                        r["launches"], paged=sched.paged)
        bad = nonfinite(sched)
        gates[f"{layout}: every step's last logits finite"] = not bad
    paged, contig = runs["paged"]["sched"], runs["contiguous"]["sched"]
    failed = [k for k, ok in gates.items() if not ok]
    for layout in runs:
        log(f"moe {mode} {layout}: decode_ms_per_step graphs / eager "
            f"{again[layout]['decode_ms']:.3f} / "
            f"{eager[layout]['decode_ms']:.3f}, tokens_per_s "
            f"{again[layout]['tokens_per_s']:.2f} / "
            f"{eager[layout]['tokens_per_s']:.2f}, peak_mem_GB "
            f"{again[layout]['peak_gb']:.2f} on {smi}")
    log(f"moe {mode} at the own capacity factor: paged and contiguous "
        f"first differ at {first_difference(runs['paged']['tokens'], runs['contiguous']['tokens'])} "
        f"(their chunks and prompts drop differently; not a gate); gates "
        f"failed: {failed}")
    if failed:
        raise AssertionError(f"moe {mode}: {failed}")
    moe_backend_parity(paged)
    moe_measure(paged, contig, reqs, smi)
    # at E / k nothing is dropped: each row alone again, up to the float
    # rounding of the expert products, whose row count is the capacity
    no_drop_phase(paged, reqs, mode)
    del runs, run, paged, contig, sched, p
    gc.collect()
    torch.cuda.empty_cache()
    for k, v in static_phase(mode, smi, OLMOE_STATIC_ARGS,
                             temps=(0.0,)).items():
        launches[k] = launches.get(k, 0) + v
    gc.collect()
    torch.cuda.empty_cache()
    log(f"moe {mode}: phase in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB left allocated")
    return launches


def no_drop_phase(sched, reqs, mode: str) -> None:
    """At capacity factor E / k nothing is dropped: ``sched``'s model on
    a paged and a contiguous scheduler against every request of
    ``reqs`` alone through ``generate_loop`` on ``cuda``, with the
    routing held and free (``no_drop_runs``), each first difference
    counted; raises on a failed gate."""
    import numpy as np
    from repro_torch.serve import (ContinuousBatchingScheduler,
                                   oracle_completion)
    # at E / k nothing is dropped: each row alone again, up to the float
    # rounding of the expert products, whose row count is the capacity
    nd = no_drop(sched.cfg)
    scheds = {
        "paged": ContinuousBatchingScheduler(
            nd, sched.params, num_slots=sched.num_slots,
            max_len=sched.max_len, kv_block_size=16, chunked_prefill=True,
            device=sched.device),
        "contiguous": ContinuousBatchingScheduler(
            nd, sched.params, num_slots=sched.num_slots,
            max_len=sched.max_len, kv_block_size=0, device=sched.device)}
    nd_tokens = {k: timed_run(s, reqs)["tokens"] for k, s in scheds.items()}
    tie, sens = moe_backend_parity(scheds["paged"])
    t1 = time.perf_counter()
    eng = scheds["paged"].engine
    solo = {r.rid: oracle_completion(eng, r) for r in reqs}
    solo_s = time.perf_counter() - t1
    ref, margins = solo_routing(eng, reqs, solo)
    failed = []
    for layout, s in scheds.items():
        res, bad = no_drop_runs(s, reqs, nd_tokens[layout], solo, ref,
                                margins, tie, sens)
        failed += [f"{layout}: {b}" for b in bad]
        log(f"moe {mode} no drops, {layout}, against each request alone "
            f"(routing held to its own, then free; by request: first "
            f"difference free / held, solo top-2 margin there, router "
            f"probabilities' max drift, routing choices that would differ "
            f"and the first three (position, layer, gap)): "
            f"{res['rows']}")
    nd_tokens["solo"] = solo
    diff = {r.rid: next((i for i, t in enumerate(zip(
        *(run[r.rid] for run in nd_tokens.values()))) if len(set(t)) > 1),
        None) for r in reqs}
    n = sum(len(t) for t in solo.values())
    agree = sum(len(solo[rid]) if i is None else i for rid, i in diff.items())
    every = np.concatenate([np.asarray(m) for m in margins.values()])
    gaps = k_gaps(np.stack([pr for by_layer in ref.values()
                            for pr, _ in by_layer.values()]), nd.moe.top_k)
    log(f"moe {mode} at capacity factor {nd.moe.capacity_factor} (no drops): "
        f"paged, contiguous and each request alone through generate_loop "
        f"(cuda backend, solo runs {solo_s:.1f} s) agree on {agree} of {n} "
        f"tokens before their first differences {diff}; near-tie "
        f"thresholds with the routing held (backend parity at this "
        f"factor): logits {tie:.4g}, router {sens:.3g}; the solo runs' "
        f"top-2 logit margins: median {float(np.median(every)):.4g}, "
        f"{100 * float((every <= tie).mean()):.1f} % of {every.size} within "
        f"{tie:.4g}; their router k-th to (k+1)-th gaps: median "
        f"{float(np.median(gaps)):.3g}, {100 * float((gaps <= sens).mean()):.1f}"
        f" % of {gaps.size} within {sens:.3g}; gates failed: {failed}")
    if failed:
        raise AssertionError(f"moe {mode} no-drop: {failed}")


def granite_run(smi: str) -> dict[str, int]:
    """granite-moe-1b-a400m at full width (24 layers, 32 experts top-8,
    GQA G = 2, head dim 64, tied embeddings) through the CLI, paged, in
    ``pum``: completions, launches, programs built once, the same trace
    from a fresh state the same tokens building nothing, logits finite;
    a decode replay's device ms."""
    import gc
    import torch
    from repro_torch.kernels import registry
    from repro_torch.launch import serve
    registry.reset_launches()
    res = serve.main(GRANITE_ARGS + ["--pum-mode", "pum"])
    torch.cuda.synchronize()
    launches = dict(registry.LAUNCHES)
    sched = res["scheduler"]
    cfg = sched.cfg
    launch_gate("pum", cfg, sched.decode_steps, sched.prefill_chunks,
                launches)
    first = tokens_of(res["completions"])
    progs = sched.step_programs()
    sched._reset()
    again = timed_run(sched, res["requests"])
    launch_gate("pum", cfg, again["steps"], again["chunks"],
                again["launches"])
    gates = {
        "6 requests x 16 tokens": len(first) == 6 and all(
            len(t) == 16 for t in first.values()),
        "each program built once, as a graph": all(
            n == 1 for n in [progs["decode"], *progs["chunk"].values()])
        and res["graphs"] == 1 + len(progs["chunk"]),
        "the same trace from a fresh state gives the same tokens, building "
        "nothing": again["tokens"] == first
        and sched.step_programs() == progs,
        "every step's last logits finite": not nonfinite(sched),
    }
    failed = [k for k, ok in gates.items() if not ok]
    replay_ms = step_device_ms(sched)
    log(f"moe {cfg.name} pum paged: {cfg.num_layers} layers d_model "
        f"{cfg.d_model}, {cfg.moe.num_experts} experts top-"
        f"{cfg.moe.top_k}; {again['steps']} decode steps + "
        f"{again['chunks']} chunks; launches {launches} (first run); "
        f"a decode replay {replay_ms:.4f} ms of device time, "
        f"decode_ms_per_step {again['decode_ms']:.3f}, tokens_per_s "
        f"{again['tokens_per_s']:.2f}, peak_mem_GB {again['peak_gb']:.2f}; "
        f"gates failed: {failed} on {smi}")
    if failed:
        raise AssertionError(f"granite: {failed}")
    del res, sched
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def moe_phase(smi: str) -> dict[str, int]:
    """Phase 11; returns each kernel's launches on its main paths."""
    import torch
    t0 = time.perf_counter()
    # the router's f32 matmul must not round its inputs to TF32
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: the MoE router runs in "
                             "f32 (models/moe.py)")
    launches: dict[str, int] = {}
    for run in (lambda: moe_run("pum", smi), lambda: moe_run("int8", smi),
                lambda: granite_run(smi)):
        for k, v in run().items():
            launches[k] = launches.get(k, 0) + v
    log(f"moe: phase 11 in {time.perf_counter() - t0:.1f} s")
    return launches


def check_moe_kernels(dev, gpu_name: str) -> dict[str, list[dict]]:
    """Phase 3's checks at the MoE family's shapes: K1 and K2 at
    OLMoE-1B-7B's 2048 x 2048 projections (a decode step's M = 4 and a
    chunk's M = 16), K3 at both head layouts, K3's duplicate-trash
    store.  Returns their rows of the kernels line."""
    mvm = mvm_sweep(dev, OLMOE_MVM, OLMOE_LAYERS, "OLMoE-1B-7B",
                    [4, 16])
    attn = check_attention(dev, gpu_name, layouts=MOE_HEADS)
    check_trash_store(dev)
    return {"bitslice_mvm_scaled": [c["K1"] for c in mvm],
            "bitslice_mvm": [c["K2"] for c in mvm],
            "paged_attention": attn}


# ---------------------------------------------------------------------------
# Phase 12: the hybrid family (Jamba-v0.1: Mamba and attention mixers,
# dense MLPs and routed experts in turn)
# ---------------------------------------------------------------------------

# Jamba-v0.1 at full width cut to one period of 8 layers (7 Mamba + 1
# attention mixers, 4 dense MLPs + 4 MoE FFNs): the f32 expert stacks of
# its 32 layers (16 MoE layers, 180 GB) exceed one card, a period's are
# 45.1 GB; fewer than 8 layers would drop its attention layer
JAMBA_LAYERS = 8
JAMBA_ARGS = ["--arch", "jamba-v0.1-52b"] + SERVE_ARGS[2:]
JAMBA_CONTIG_ARGS = ["--arch", "jamba-v0.1-52b"] + CONTIG_ARGS[2:]
JAMBA_STATIC_ARGS = ["--arch", "jamba-v0.1-52b"] + STATIC_ARGS[2:]
# its projections on the MVM kernels by (K, N), counted over a forward
# pass: in, x, dt and out of the 7 Mamba layers; q, o and k, v of the
# attention layer; gate, up and down of the 4 MLPs: 44
JAMBA_MVM = {(4096, 16384): 7, (8192, 288): 7, (256, 8192): 7,
             (8192, 4096): 7, (4096, 4096): 2, (4096, 1024): 2,
             (4096, 14336): 8, (14336, 4096): 4}
# its attention layout: KV heads, queries a KV head, head dim
JAMBA_HEADS = (8, 4, 128)


def jamba_cut(**kw):
    """Jamba-v0.1's published config at ``JAMBA_LAYERS`` layers."""
    from repro_torch import configs
    return configs.get("jamba-v0.1-52b").replace(num_layers=JAMBA_LAYERS,
                                                  **kw)


def check_hybrid_kernels(dev, gpu_name: str) -> dict[str, list[dict]]:
    """Phase 3's checks at Jamba-v0.1's shapes: K1 and K2 at its eight
    projection shapes (a decode step's M = 4 and a chunk's M = 16), K3 at
    KV = 8, G = 4, hd = 128.  Returns their rows of the kernels line."""
    mvm = mvm_sweep(dev, JAMBA_MVM, JAMBA_LAYERS, "Jamba-v0.1 (one period)",
                    [4, 16])
    attn = check_attention(dev, gpu_name, layouts=[JAMBA_HEADS])
    return {"bitslice_mvm_scaled": [c["K1"] for c in mvm],
            "bitslice_mvm": [c["K2"] for c in mvm],
            "paged_attention": attn}


def mamba_cells_ms(cfg, slots: int, tokens: int = 1) -> float:
    """Device time of the Mamba layers' work outside their projections in
    one forward of ``tokens`` tokens (1: a decode step), alone: each
    layer's conv over its window, dt's softplus, the state update token
    by token and the output gate (``models/ssm.py``) at ``slots`` rows
    on random inputs."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import ssm, transformer
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(6)
    inner, st = ssm._inner(cfg), cfg.ssm_state_dim

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    conv_w, conv_b = rnd(inner, cfg.ssm_conv_width) * 0.2, rnd(inner)
    a_log = torch.log(torch.arange(1, st + 1, device=dev,
                                   dtype=torch.float32)).repeat(inner, 1)
    window, h = rnd(slots, cfg.ssm_conv_width - 1, inner), rnd(slots, inner,
                                                               st)
    xi, z = (rnd(slots, tokens, inner).to(torch.bfloat16)
             for _ in range(2))
    dt_raw = rnd(slots, tokens, inner)
    b_t, c_t = rnd(slots, tokens, st), rnd(slots, tokens, st)
    d_skip = torch.ones(inner, device=dev)
    layers = sum(transformer.layer_kinds(cfg, j)[0] == "mamba"
                 for j in range(cfg.num_layers))

    def cells():
        for _ in range(layers):
            ext = torch.cat([window, xi.float()], dim=1)
            xc = F.silu(ssm._causal_conv(ext, conv_w, conv_b))
            dt = ssm._softplus(dt_raw)
            _, y = ssm._recurrence(h, xc, dt, b_t, c_t,
                                   -torch.exp(a_log), d_skip)
            y.to(torch.bfloat16) * F.silu(z)
    return device_ms(cells, iters=2)


def hybrid_measure(paged, contig, reqs, smi: str) -> None:
    """Phase 12's numbers in one mode: phase 11's (a decode replay and
    its split under the profiler, the expert cast and products alone, a
    64-token prefill, the dropped share), the Mamba layers' conv and
    recurrence alone and their share of the replay and of the prefill,
    the state bytes a slot and the KV bytes a token."""
    from repro_torch.models import lm, transformer
    cfg = paged.cfg
    times = moe_measure(paged, contig, reqs, smi)
    replay_ms, prefill_ms = times["replay_ms"], times["prefill_ms"]
    cells_ms = mamba_cells_ms(cfg, paged.num_slots)
    prefill_cells_ms = mamba_cells_ms(cfg, 1, 64)
    state = sum(t.nbytes for t in lm.recurrent_tensors(
        cfg, paged.states)) / paged.num_slots
    attn = sum(transformer.layer_kinds(cfg, j)[0] == "attn"
               for j in range(cfg.num_layers))
    kv = attn * 2 * cfg.num_kv_heads * cfg.resolved_head_dim * 2
    log(f"hybrid {cfg.pum.mode}: a decode replay {replay_ms:.4f} ms, of it "
        f"the Mamba layers' conv and recurrence (timed alone, "
        f"{paged.num_slots} rows) {cells_ms:.4f} ms = "
        f"{100 * cells_ms / replay_ms:.1f} %; a 64-token prefill "
        f"{prefill_ms:.3f} ms, of it the Mamba layers' conv and per-token "
        f"recurrence (alone) {prefill_cells_ms:.3f} ms = "
        f"{100 * prefill_cells_ms / prefill_ms:.1f} %; SSM state (h and "
        f"conv window, f32) {state / 1e6:.2f} MB a slot, KV {kv} bytes a "
        f"token "
        f"({attn} attention layer) on {smi}")


def hybrid_run(mode: str, smi: str) -> dict[str, int]:
    """Phase 12 in one mode: the CLI paged and contiguous on Jamba's
    period (its main paths, whose launches are returned with the static
    batch's), then the gates at the config's own capacity factor and at
    E / k.  One model on the card at a time: the contiguous scheduler's
    weights serve the paged scheduler after the CLI runs (the same seed,
    so the same weights)."""
    import gc
    import torch
    from repro_torch.kernels import registry
    from repro_torch.launch import serve
    from repro_torch.serve import ContinuousBatchingScheduler
    t0 = time.perf_counter()
    cfg = jamba_cut()
    launches: dict[str, int] = {}
    cli = {}
    for layout, args in (("paged", JAMBA_ARGS),
                         ("contiguous", JAMBA_CONTIG_ARGS)):
        torch.cuda.reset_peak_memory_stats()
        registry.reset_launches()
        res = serve.main(args + ["--pum-mode", mode], cfg=cfg)
        torch.cuda.synchronize()
        counts = dict(registry.LAUNCHES)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        sched = res["scheduler"]
        launch_gate(mode, sched.cfg, sched.decode_steps,
                    sched.prefill_chunks, counts, paged=sched.paged)
        progs = sched.step_programs()
        built = [progs["decode"], *next(v for k, v in progs.items()
                                        if k != "decode").values()]
        comps = res["completions"]
        vp = sched.params["embed"].shape[0]
        if len(comps) != 6 or any(
                len(c.tokens) != 16 or not all(0 <= t < vp for t in c.tokens)
                for c in comps.values()) \
                or any(n != 1 for n in built) \
                or res["graphs"] != len(built):
            raise AssertionError(f"hybrid {mode} {layout}: completions "
                                 f"{tokens_of(comps)}, programs {progs}, "
                                 f"{res['graphs']} graphs")
        log(f"hybrid {mode} {layout}: {sched.cfg.name} cut to "
            f"{sched.cfg.num_layers} layers, d_model {sched.cfg.d_model}, "
            f"{moe_layers(sched.cfg)} MoE layers of "
            f"{sched.cfg.moe.num_experts} experts top-{sched.cfg.moe.top_k} "
            f"at capacity factor {sched.cfg.moe.capacity_factor}; 6 requests "
            f"x 16 tokens, {sched.decode_steps} decode steps + "
            f"{sched.prefill_chunks} prefill "
            f"{'chunks' if sched.paged else 'prompts'}; launches {counts} "
            f"(replays counted); programs {progs}, {res['graphs']} graphs "
            f"built in {res['build_s']:.2f} s; setup {res['setup_s']:.2f} s; "
            f"peak_mem_GB {torch.cuda.max_memory_allocated() / 1e9:.2f}")
        cli[layout] = dict(tokens=tokens_of(comps), requests=res["requests"])
        if layout == "paged":
            del res, sched, comps
            gc.collect()
            torch.cuda.empty_cache()
    contig = sched
    del res
    paged = ContinuousBatchingScheduler(
        contig.cfg, contig.params, num_slots=contig.num_slots,
        max_len=contig.max_len, kv_block_size=16, chunked_prefill=True,
        device=contig.device)
    reqs = cli["paged"]["requests"]
    gates, again = {}, {}
    for layout, sched in (("paged", paged), ("contiguous", contig)):
        # the trace again from the state a fresh scheduler starts in (the
        # idle rows take expert capacity)
        sched._reset()
        again[layout] = timed_run(sched, reqs)
        progs = sched.step_programs()
        sched._reset()
        twice = timed_run(sched, reqs)
        eager = timed_run(like(sched, cuda_graphs=False), reqs)
        gates[f"{layout}: the same trace from a fresh state gives the CLI's "
              f"tokens, twice, building nothing after its first"] = (
            again[layout]["tokens"] == cli[layout]["tokens"]
            == twice["tokens"] and sched.step_programs() == progs
            and progs["decode"] == 1)
        gates[f"{layout}: graphs and eager give the same tokens and "
              f"launches"] = (eager["tokens"] == cli[layout]["tokens"]
                              and eager["launches"] == twice["launches"])
        for r in (again[layout], twice, eager):
            launch_gate(mode, sched.cfg, r["steps"], r["chunks"],
                        r["launches"], paged=sched.paged)
        bad = nonfinite(sched)
        gates[f"{layout}: the SSM states and every step's last logits "
              f"finite"] = not bad
        # timed on the second run from a fresh state: every program built
        log(f"hybrid {mode} {layout}: decode_ms_per_step graphs / eager "
            f"{twice['decode_ms']:.3f} / {eager['decode_ms']:.3f}, "
            f"tokens_per_s {twice['tokens_per_s']:.2f} / "
            f"{eager['tokens_per_s']:.2f}, peak_mem_GB "
            f"{twice['peak_gb']:.2f}; non-finite {bad} on {smi}")
        del eager
    failed = [k for k, ok in gates.items() if not ok]
    split = first_difference(cli["paged"]["tokens"],
                             cli["contiguous"]["tokens"])
    log(f"hybrid {mode} at the own capacity factor: paged and contiguous "
        f"first differ at {split} "
        f"(their chunks and prompts drop differently; not a gate); gates "
        f"failed: {failed}")
    if failed:
        raise AssertionError(f"hybrid {mode}: {failed}")
    moe_backend_parity(paged)
    hybrid_measure(paged, contig, reqs, smi)
    # the paged scheduler's graphs go before the no-drop schedulers
    # build their own
    del paged, sched
    gc.collect()
    torch.cuda.empty_cache()
    no_drop_phase(contig, reqs, mode)
    del contig
    gc.collect()
    torch.cuda.empty_cache()
    for k, v in static_phase(mode, smi, JAMBA_STATIC_ARGS, temps=(0.0,),
                             cfg=cfg).items():
        launches[k] = launches.get(k, 0) + v
    gc.collect()
    torch.cuda.empty_cache()
    log(f"hybrid {mode}: phase in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB left allocated")
    return launches


def dense_ffn_run(smi: str) -> dict[str, int]:
    """The sharp gate on the Mamba mixer: Jamba's period with its MoE
    FFNs made dense (all 8 FFNs MLPs of d_ff 14336; no capacity couples
    the rows), ``pum``, phase 8's sampled requests: on contiguous windows
    each completion equals its request alone through ``generate_loop``
    on ``cuda`` bit for bit (both attend through the plain composition);
    paged, the same on the ``torch`` backend; paged on ``cuda`` (K3 sums
    in another order than the solo's attention) the first differences
    are counted, not gated.  Then the prefix cache on the same period
    (``prefix_check``), whose cold run's launches are returned."""
    import dataclasses
    import gc
    import torch
    from repro_torch.config import MoEConfig, PUMConfig
    from repro_torch.models import lm
    from repro_torch.serve import (ContinuousBatchingScheduler,
                                   oracle_completion, synthetic_workload)
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    cfg = jamba_cut(moe=MoEConfig(), pum=PUMConfig(mode="pum"))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = lm.prepack_for_serving(lm.init_params(cfg, gen, device=dev),
                                    cfg)
    base = synthetic_workload(6, cfg.vocab_size, min_prompt=20,
                              max_prompt=64, max_new=16, seed=0)
    reqs = [dataclasses.replace(r, temperature=t, seed=s) for r, t, s in
            zip(base, SAMPLED_TEMPS, SAMPLED_SEEDS)]
    # phase 4's trace on the CLI's geometry (4 slots, a window of 64 + 16
    # + 1 positions)
    geometry = dict(num_slots=4, max_len=81, device=dev)
    contig = ContinuousBatchingScheduler(cfg, params, kv_block_size=0,
                                         **geometry)
    run = timed_run(contig, reqs)
    launch_gate("pum", cfg, run["steps"], run["chunks"], run["launches"],
                paged=False)
    contig_t = run["tokens"]
    solo = {r.rid: oracle_completion(contig.engine, r) for r in reqs}
    del contig
    gc.collect()
    paged = ContinuousBatchingScheduler(cfg, params, kv_block_size=16,
                                        chunked_prefill=True, **geometry)
    paged_t = tokens_of(paged.run(reqs))
    # speculative decoding: blocks, Mamba's h and conv rows
    spec = spec_check("jamba-v0.1 period, dense FFNs", paged, reqs, paged_t,
                      smi)["launches"]
    del paged
    gc.collect()
    plain = ContinuousBatchingScheduler(cfg, params, kv_block_size=16,
                                        chunked_prefill=True,
                                        kernel_backend="torch", **geometry)
    plain_t = tokens_of(plain.run(reqs))
    plain_solo = {r.rid: oracle_completion(plain.engine, r) for r in reqs}
    del plain
    gc.collect()
    # the prefix cache: shared KV blocks and Mamba snapshots together
    launches = prefix_check("jamba-v0.1 period, dense FFNs", "hybrid", cfg,
                            params, smi)
    for k, v in spec.items():
        launches[k] = launches.get(k, 0) + v
    del params
    gc.collect()
    torch.cuda.empty_cache()
    diff = first_difference(paged_t, solo)
    gates = {
        "contiguous, cuda: each completion equals its request alone "
        "through generate_loop": contig_t == solo,
        "paged, torch backend: each completion equals its request alone "
        "through generate_loop": plain_t == plain_solo,
    }
    failed = [k for k, ok in gates.items() if not ok]
    log(f"hybrid dense-FFN variant (pum, {cfg.num_layers} layers, "
        f"{per_pass(cfg)[0]} MVM a forward): 6 requests at temperatures "
        f"{list(SAMPLED_TEMPS)}; contiguous on cuda vs solo first "
        f"differences {first_difference(contig_t, solo)}; paged on torch vs "
        f"solo {first_difference(plain_t, plain_solo)}; paged on cuda (K3) "
        f"vs the cuda solo {diff}: {sum(i is not None for i in diff.values())}"
        f" of 6 requests part at a near-tie (not a gate); "
        f"{time.perf_counter() - t0:.1f} s; gates failed: {failed} on {smi}")
    if failed:
        raise AssertionError(f"hybrid dense-FFN variant: {failed}")
    return launches


def hybrid_phase(smi: str) -> dict[str, int]:
    """Phase 12; returns each kernel's launches on its main paths."""
    import torch
    t0 = time.perf_counter()
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: the MoE router runs in "
                             "f32 (models/moe.py)")
    launches: dict[str, int] = {}
    for mode in ("pum", "int8"):
        for k, v in hybrid_run(mode, smi).items():
            launches[k] = launches.get(k, 0) + v
    for k, v in dense_ffn_run(smi).items():
        launches[k] = launches.get(k, 0) + v
    log(f"hybrid: phase 12 in {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 13: the rest of the registry (glm4-9b, minicpm-2b,
# command-r-plus-104b, llava-next-mistral-7b, whisper-tiny)
# ---------------------------------------------------------------------------

# command-r-plus-104b at full width cut to CR_LAYERS of its 64 layers:
# 7.87 GB of packed ``pum`` weights a layer beside a 12.6 GB f32 tied
# embedding (its 64 layers hold 516 GB); the deepest cut whose peak, the
# torch backend's f64 plain products included, stays under ~70 GB
CR_LAYERS = 6
# their projections on the MVM kernels by (K, N), counted over a
# layer: q and o, k and v, gate and up, down
GLM4_MVM = {(4096, 4096): 2, (4096, 256): 2, (4096, 13696): 2,
            (13696, 4096): 1}
MINICPM_MVM = {(2304, 2304): 4, (2304, 5760): 2, (5760, 2304): 1}
CR_MVM = {(12288, 12288): 2, (12288, 1024): 2, (12288, 33792): 2,
          (33792, 12288): 1}
# whisper-tiny's encoder: q, k, v, o and the GELU MLP's up and down,
# over 4 requests x 1500 frames (each decode step's cross K and V
# projections take these rows too)
WHISPER_BATCH, WHISPER_FRAMES = 4, 1500
WHISPER_ENC_MVM = {(384, 384): 4, (384, 1536): 1, (1536, 384): 1}
WHISPER_PROMPT, WHISPER_GEN = 4, 16
# K3 at their head layouts (KV heads, queries a KV head, head dim):
# glm4-9b's G = 16 and command-r-plus-104b's G = 12 (one position's
# heads over two CTAs of 8 queries), minicpm-2b's MHA at hd 64
FAMILY_HEADS = [(2, 16, 128), (8, 12, 128), (36, 1, 64)]
FAMILY_ATTN_CASES = [(1, 81), (SPEC_K + 1, 81), (16, 81), (1, 1024)]
# llava's image prefix: its 2880 image embeddings before a 16-token
# prompt (2896 positions, past 2 * CHUNK_Q: the online softmax), then
# greedy decode steps
LLAVA_PROMPT, LLAVA_STEPS = 16, 8
# phase 13 serves glm4-9b and minicpm-2b at full width cut to this many
# of their 40 layers (40 until phase 16 came: the script's time on a
# slow host)
FAMILY_LAYERS = 20


def family_cut(arch: str):
    """glm4-9b's or minicpm-2b's published config at ``FAMILY_LAYERS``
    layers (every gate of their runs compares runs of one config)."""
    from repro_torch import configs
    return configs.get(arch).replace(num_layers=FAMILY_LAYERS)


def cr_cut(**kw):
    """command-r-plus-104b's published config at ``CR_LAYERS`` layers."""
    from repro_torch import configs
    return configs.get("command-r-plus-104b").replace(num_layers=CR_LAYERS,
                                                       **kw)


def check_family_kernels(dev, gpu_name: str) -> dict[str, list[dict]]:
    """Phase 3's checks at phase 13's shapes: K1 and K2 at glm4-9b's and
    minicpm-2b's projections (a decode step's M = 4), command-r-plus'
    (M = 4 and a chunk's 16: K = 33792 split over a cluster) and
    whisper-tiny's encoder (M = 6000), bit for bit; K3 at G = 16, G = 12
    and (KV 36, G 1, hd 64) at S = 1, 4 and 16 over T = 81 and at T =
    1024, pools bit for bit.  Returns their rows of the kernels line."""
    def stack(shapes, layers):
        return {s: layers * c for s, c in shapes.items()}

    mvm = (mvm_sweep(dev, stack(GLM4_MVM, 40), 40, "glm4-9b", [4])
           + mvm_sweep(dev, stack(MINICPM_MVM, 40), 40, "minicpm-2b", [4])
           + mvm_sweep(dev, stack(CR_MVM, CR_LAYERS), CR_LAYERS,
                       f"command-r-plus-104b (cut to {CR_LAYERS})", [4, 16])
           + mvm_sweep(dev, stack(WHISPER_ENC_MVM, 4), 4,
                       "whisper-tiny's encoder",
                       [WHISPER_BATCH * WHISPER_FRAMES]))
    attn = check_attention(dev, gpu_name, layouts=FAMILY_HEADS,
                           cases=FAMILY_ATTN_CASES)
    return {"bitslice_mvm_scaled": [c["K1"] for c in mvm],
            "bitslice_mvm": [c["K2"] for c in mvm],
            "paged_attention": attn}


def family_cli(arch: str, mode: str, smi: str, cfg=None):
    """One of glm4-9b, minicpm-2b, command-r-plus-104b (``cfg``: its cut)
    or llava's text at full width through the paged CLI on phase 4's
    trace, gated as granite's run: completions, the launch counts, each
    program built once as a graph, the same trace from a fresh state
    the same tokens building nothing, every step's logits finite, then
    backend parity (``cuda`` against ``torch`` logits on one chunk and
    one step within the one-ulp nudge's change).  Returns the CLI's
    result and the launches of its run."""
    import torch
    from repro_torch.kernels import registry
    from repro_torch.launch import serve
    torch.cuda.reset_peak_memory_stats()
    registry.reset_launches()
    res = serve.main(["--arch", arch] + SERVE_ARGS[2:]
                     + ["--pum-mode", mode], cfg=cfg)
    torch.cuda.synchronize()
    launches = dict(registry.LAUNCHES)
    load_gb = torch.cuda.max_memory_allocated() / 1e9
    sched = res["scheduler"]
    cfg = sched.cfg
    got = launch_gate(mode, cfg, sched.decode_steps, sched.prefill_chunks,
                      launches)
    first = tokens_of(res["completions"])
    progs = sched.step_programs()
    sched._reset()
    again = timed_run(sched, res["requests"])
    launch_gate(mode, cfg, again["steps"], again["chunks"],
                again["launches"])
    vp = sched.params["embed"].shape[0]
    gates = {
        "6 requests x 16 tokens in the vocabulary": len(first) == 6 and all(
            len(t) == 16 and all(0 <= x < vp for x in t)
            for t in first.values()),
        "each program built once, as a graph": all(
            n == 1 for n in [progs["decode"], *progs["chunk"].values()])
        and res["graphs"] == 1 + len(progs["chunk"]),
        "the same trace from a fresh state gives the same tokens, building "
        "nothing": again["tokens"] == first
        and sched.step_programs() == progs,
        "every step's last logits finite": not nonfinite(sched),
    }
    failed = [k for k, ok in gates.items() if not ok]
    mvm, attn = per_pass(cfg)
    log(f"families {cfg.name} {mode} paged: {cfg.num_layers} layers "
        f"d_model {cfg.d_model}, {cfg.num_heads} heads / {cfg.num_kv_heads} "
        f"KV (G = {cfg.num_heads // cfg.num_kv_heads}, hd "
        f"{cfg.resolved_head_dim}); {sched.decode_steps} decode steps + "
        f"{sched.prefill_chunks} chunks; launches {got} ({mvm} MVM + {attn} "
        f"K3 a step or chunk); programs {progs}; load and first run "
        f"peak_mem_GB {load_gb:.2f}; gates failed: {failed}")
    if failed:
        raise AssertionError(f"families {cfg.name} {mode}: {failed}")
    backend_parity(sched, near_ties=True)
    replay_ms = step_device_ms(sched)
    log(f"families {cfg.name} {mode}: decode_ms_per_step "
        f"{again['decode_ms']:.3f}, tokens_per_s {again['tokens_per_s']:.2f} "
        f"(a fresh-state rerun, nothing built), a decode replay "
        f"{replay_ms:.4f} ms of device time, peak_mem_GB "
        f"{again['peak_gb']:.2f}, setup {res['setup_s']:.2f} s on {smi}")
    return res, launches


def llava_image(sched, smi: str) -> dict[str, int]:
    """llava's image path on the CLI's params: one ``lm.forward`` over
    2880 image embeddings (``vision_proj``) and a 16-token prompt into
    contiguous states, then 8 greedy steps through ``ServeEngine.decode``,
    on the ``cuda`` backend (225 MVM launches for the prefix, 224 a step,
    no K3), the ``torch`` backend and ``cuda`` with layer 0's input
    nudged one bf16 ulp, both fed the cuda run's tokens: logits within
    the nudge's change, the same greedy token at every call, finite.
    Returns the cuda run's launches."""
    import torch
    from repro_torch.kernels import registry
    from repro_torch.models import lm
    from repro_torch.serve import ServeEngine
    cfg, params, dev = sched.cfg, sched.params, sched.device
    g = torch.Generator(device=dev).manual_seed(5)
    img = torch.randn((1, cfg.num_image_tokens, cfg.d_model), generator=g,
                      device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (1, LLAVA_PROMPT),
                           generator=g, device=dev, dtype=torch.int32)
    s = cfg.num_image_tokens + LLAVA_PROMPT
    engines = {name: ServeEngine(cfg, p, max_len=s + LLAVA_STEPS,
                                 prepack=False, kernel_backend=backend,
                                 device=dev)
               for name, p, backend in (("cuda", params, "cuda"),
                                        ("torch", params, "torch"),
                                        ("nudged", nudged(params), "cuda"))}

    def run(eng, toks=None):
        states = lm.init_state(cfg, 1, eng.max_len, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode(), eng.backend_ctx():
            logits, _ = lm.forward(eng.params, prompt, cfg, states=states,
                                   cache_index=0, image_embeds=img,
                                   last_only=True)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        rows, chosen = [logits[:, -1]], []
        t0 = time.perf_counter()
        for i in range(LLAVA_STEPS):
            tok = toks[i] if toks is not None else rows[-1].argmax(
                -1).reshape(1, 1).to(torch.int32)
            chosen.append(tok)
            logits, states = eng.decode(states, tok, s + i)
            rows.append(logits[:, -1])
        torch.cuda.synchronize()
        return (torch.cat(rows).float(), chosen, prefill_s,
                (time.perf_counter() - t0) / LLAVA_STEPS)

    torch.cuda.reset_peak_memory_stats()
    registry.reset_launches()
    a, toks, prefill_s, step_s = run(engines["cuda"])
    launches = dict(registry.LAUNCHES)
    b = run(engines["torch"], toks)[0]
    c = run(engines["nudged"], toks)[0]
    mvm, _ = per_pass(cfg)
    want = {"bitslice_mvm_scaled": mvm + 1 + LLAVA_STEPS * mvm}
    err = (a - b).abs().max().item()
    bound = (c - a).abs().max().item()
    gates = {
        f"launches {want}, no K3": launches == want,
        "cuda against torch logits within the one-ulp nudge's change":
            0 < bound and err <= bound,
        "the same greedy token at every call on both backends": bool(
            (a.argmax(-1) == b.argmax(-1)).all()),
        "finite logits": all(bool(torch.isfinite(t).all())
                             for t in (a, b, c)),
    }
    failed = [k for k, ok in gates.items() if not ok]
    log(f"families {cfg.name} image prefix: {cfg.num_image_tokens} image "
        f"embeddings + {LLAVA_PROMPT} prompt tokens = {s} positions (online "
        f"softmax), then {LLAVA_STEPS} greedy steps "
        f"{[int(t) for t in toks]}; launches {launches}; max|cuda - torch| "
        f"{err:.4g}, bound {bound:.4g}, max|logit| {b.abs().max().item():.4g}"
        f"; prefix {1e3 * prefill_s:.1f} ms wall, decode {1e3 * step_s:.3f} "
        f"ms/step (eager), peak_mem_GB "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f}; gates failed: "
        f"{failed} on {smi}")
    if failed:
        raise AssertionError(f"llava image prefix: {failed}")
    return launches


def whisper_run(smi: str, ibert: bool = False) -> dict[str, int]:
    """whisper-tiny at full width and depth (4 + 4 layers), ``pum`` (with
    ``ibert``, under ``pum.ibert``: the I-BERT softmax over the encoder's
    frames and the cross-attention, the I-BERT GELU, the same launches):
    ``ServeEngine.generate(encoder_frames=)`` on 4 requests of 1500
    frames and a 4-token prompt, 16 tokens each: prefill (the encoder,
    24 MVM, then 40 decoder MVM) and 15 decode steps (40 MVM each: 8 of
    them the cross K/V over 6000 rows), no K3; gated: the compiled loop
    equals ``generate_loop`` and the ``torch`` backend's tokens, its two
    programs built once (a second call builds nothing and gives the
    same tokens), other frames other tokens.  Returns the first call's
    launches."""
    import gc
    import torch
    from repro_torch import configs
    from repro_torch.config import PUMConfig
    from repro_torch.kernels import registry
    from repro_torch.models import lm
    from repro_torch.serve import ServeEngine
    dev = torch.device("cuda", 0)
    cfg = configs.get("whisper-tiny").replace(
        pum=PUMConfig(mode="pum", ibert=ibert))
    g = torch.Generator(device=dev).manual_seed(0)
    params = lm.init_params(cfg, g, device=dev, pack=True)
    frames = torch.randn((WHISPER_BATCH, WHISPER_FRAMES, cfg.d_model),
                         generator=g, device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (WHISPER_BATCH,
                                               WHISPER_PROMPT),
                           generator=g, device=dev, dtype=torch.int32)
    max_len = WHISPER_PROMPT + WHISPER_GEN + 1
    eng = ServeEngine(cfg, params, max_len=max_len, prepack=False,
                      device=dev)
    torch.cuda.reset_peak_memory_stats()
    registry.reset_launches()
    t0 = time.perf_counter()
    out = eng.generate(prompt, WHISPER_GEN, encoder_frames=frames)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(registry.LAUNCHES)
    progs = eng.scan_programs()
    t0 = time.perf_counter()
    again = eng.generate(prompt, WHISPER_GEN, encoder_frames=frames)
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t0
    loop = eng.generate_loop(prompt, WHISPER_GEN, encoder_frames=frames)
    plain = ServeEngine(cfg, params, max_len=max_len, prepack=False,
                        kernel_backend="torch", device=dev).generate(
        prompt, WHISPER_GEN, encoder_frames=frames)
    other = eng.generate(prompt, WHISPER_GEN, encoder_frames=frames * 2)
    mvm, _ = per_pass(cfg)
    enc = sum(WHISPER_ENC_MVM.values()) * cfg.encoder_layers
    step = mvm + 4 * cfg.num_layers             # self + cross q, k, v, o
    want = {"bitslice_mvm_scaled": enc + WHISPER_GEN * step}
    key = (WHISPER_BATCH, WHISPER_PROMPT, 0.0,
           (WHISPER_FRAMES, cfg.d_model, torch.float32))
    gates = {
        f"launches {want} (prefill {enc} encoder + {step} decoder MVM, "
        f"{step} a step), no K3": launches == want,
        "the compiled loop equals generate_loop": torch.equal(out, loop),
        "the cuda backend's tokens equal the torch backend's":
            torch.equal(out, plain),
        "its two programs built once, as graphs; a second call builds "
        "nothing and gives the same tokens": progs == {key: 1}
        and eng.scan_programs() == progs
        and eng.graphs_captured()[0] == 2 and torch.equal(again, out),
        "other frames give other tokens": not torch.equal(other, out),
    }
    failed = [k for k, ok in gates.items() if not ok]
    decode = eng._scans[key][1]
    replay_ms = event_ms(decode.launch, reps=20)
    toks = WHISPER_BATCH * WHISPER_GEN
    log(f"families {cfg.name} pum{' ibert' if ibert else ''}: "
        f"{cfg.encoder_layers} encoder + "
        f"{cfg.num_layers} decoder layers, d_model {cfg.d_model}; "
        f"generate(encoder_frames=[{WHISPER_BATCH}, {WHISPER_FRAMES}, "
        f"{cfg.d_model}]) x {WHISPER_GEN} tokens: launches {launches}; "
        f"first call (builds included) {first_s:.3f} s, steady "
        f"{steady_s:.3f} s = {toks / steady_s:.1f} tok/s "
        f"({1e3 * steady_s / WHISPER_GEN:.3f} ms a token step, prefill "
        f"included), a decode replay {replay_ms:.4f} ms of device time, "
        f"graphs built in {eng.graphs_captured()[1]:.2f} s, peak_mem_GB "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f}; sample "
        f"{out[0, WHISPER_PROMPT:].tolist()}; gates failed: {failed} on "
        f"{smi}")
    if failed:
        raise AssertionError(f"whisper{' ibert' if ibert else ''}: "
                             f"{failed}")
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def families_phase(smi: str) -> dict[str, int]:
    """Phase 13; returns each kernel's launches on its main paths."""
    import gc
    import torch
    t0 = time.perf_counter()
    launches: dict[str, int] = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    for arch, mode, cfg in (("glm4-9b", "pum", family_cut("glm4-9b")),
                            ("glm4-9b", "int8", family_cut("glm4-9b")),
                            ("minicpm-2b", "pum", family_cut("minicpm-2b")),
                            ("command-r-plus-104b", "pum", cr_cut()),
                            ("llava-next-mistral-7b", "pum", None)):
        res, counts = family_cli(arch, mode, smi, cfg)
        add(counts)
        if res["scheduler"].cfg.vision_stub:
            add(llava_image(res["scheduler"], smi))
        del res
        gc.collect()
        torch.cuda.empty_cache()
        log(f"families: {arch} {mode} done at {time.perf_counter() - t0:.1f}"
            f" s of the phase")
    add(whisper_run(smi))
    log(f"families: phase 13 in {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 14: the resilient front end and fault tolerance
# ---------------------------------------------------------------------------

FE_STORM = "seed=0,fault=0.1,victim=0.08,chunk=0.08,stall=0.08,stall_ticks=2"
# a virtual deadline (ms of the front end's clock, 0.01 s a pump) that
# expires requests of the storm's trace both in the queue and mid-decode
# (worked out on the CPU at the same trace: the tick structure depends
# on the prompts' lengths and the arrivals, not on token values)
FE_DEADLINE_MS = "300"
FE_ARGS = SERVE_ARGS + ["--frontend", "--workload", "poisson", "--requests",
                        "12", "--max-queue", "6", "--policy", "edf",
                        "--chaos", FE_STORM]
FE_CONTIG_ARGS = CONTIG_ARGS + ["--frontend", "--workload", "poisson",
                                "--requests", "12", "--max-queue", "6",
                                "--policy", "edf", "--chaos", FE_STORM]
FE_STATUSES = ("ok", "rejected", "expired", "cancelled", "failed")


def fe_outcomes(results: dict, want: dict[int, list[int]],
                label: str) -> dict[int, tuple]:
    """Gate a front end's results against the fault-free tokens: every
    rid resolved with a typed status, each ``ok`` request's tokens equal
    to ``want`` bit for bit, every other one's partial a prefix of them
    with a typed error.  Returns {rid: (status, attempts, tokens)}."""
    from repro_torch.serve import FrontendError
    if sorted(results) != sorted(want):
        raise AssertionError(f"{label}: resolved {sorted(results)}, trace "
                             f"{sorted(want)}")
    out = {}
    for rid, r in sorted(results.items()):
        if r.status not in FE_STATUSES:
            raise AssertionError(f"{label}: rid {rid} status {r.status}")
        if r.ok and r.tokens != want[rid]:
            raise AssertionError(f"{label}: rid {rid} ok with {r.tokens}, "
                                 f"fault-free {want[rid]}")
        if not r.ok and (not isinstance(r.error, FrontendError)
                         or r.tokens != want[rid][:len(r.tokens)]):
            raise AssertionError(f"{label}: rid {rid} {r.status} error "
                                 f"{r.error!r} partial {r.tokens} against "
                                 f"{want[rid]}")
        out[rid] = (r.status, r.attempts, r.tokens)
    return out


def fe_clean(sched, label: str) -> None:
    """Nothing in flight, every slot free, no block of the pool live."""
    live = sched._alloc.live_blocks if sched.paged else 0
    if sched.in_flight() or sched._prefills or sched._active.any() or live \
            or sched.num_free_slots != sched.num_slots:
        raise AssertionError(f"{label}: in flight {sched.in_flight()}, "
                             f"{live} blocks live after the run")


def fe_storm(args_list: list[str], mode: str, smi: str, cfg=None,
             paged: bool = True) -> tuple[dict, dict[str, int]]:
    """14a / 14c: the CLI under the storm, then the gates; returns the
    CLI's result (with ``first``, the storm's outcomes, and ``free``,
    the fault-free run) and the launches of the storm and its replay."""
    import torch
    from repro_torch.kernels import registry
    from repro_torch.launch import serve
    label = f"frontend {'paged' if paged else 'contiguous'} {mode}"
    registry.reset_launches()
    res = serve.main(args_list + ["--pum-mode", mode], cfg=cfg)
    torch.cuda.synchronize()
    launches = dict(registry.LAUNCHES)
    sched, fe, reqs = res["scheduler"], res["frontend"], res["requests"]
    # a fresh scheduler: its counters are the storm's dispatches
    steps, chunks = sched.decode_steps, sched.prefill_chunks
    got = launch_gate(mode, sched.cfg, steps, chunks, launches, paged=paged)
    if fe.chaos is None or fe.chaos.injected == 0:
        raise AssertionError(f"{label}: no fault injected")
    fe_clean(sched, label)
    snap = res["snapshot"]
    # the fault-free run of the same trace on the same scheduler
    free = timed_run(sched, reqs)
    first = fe_outcomes(res["results"], free["tokens"], label)
    if "ok" not in [v[0] for v in first.values()]:
        raise AssertionError(f"{label}: no request survived: {first}")
    # the same seed again: the same outcomes, dispatches and launches,
    # and no step built
    progs, graphs = sched.step_programs(), sched.graphs_captured()[0]
    registry.reset_launches()
    before = sched.decode_steps, sched.prefill_chunks
    fe2 = serve.build_frontend(sched, res["args"])
    again = fe2.results(fe2.serve_trace(reqs))
    torch.cuda.synchronize()
    second = fe_outcomes(again, free["tokens"], label + " replay")
    replay = dict(registry.LAUNCHES)
    moved = (sched.decode_steps - before[0], sched.prefill_chunks - before[1])
    if second != first or replay != launches or moved != (steps, chunks):
        raise AssertionError(f"{label}: the same seed gave other outcomes, "
                             f"dispatches or launches: {second} / {first}, "
                             f"{moved} / {(steps, chunks)}, {replay} / "
                             f"{launches}")
    if sched.step_programs() != progs or sched.graphs_captured()[0] != \
            graphs or graphs != len(sched._programs):
        raise AssertionError(f"{label}: the storm built steps: "
                             f"{sched.step_programs()} (had {progs}), "
                             f"{sched.graphs_captured()[0]} graphs")
    fe_clean(sched, label + " replay")
    log(f"{label}: {sched.cfg.num_layers} layers, 12 requests, outcomes "
        f"{res['outcomes']}, faults injected {fe.chaos.injected} (absorbed "
        f"{snap['serve.faults']:.0f}), retries {snap['serve.retries']:.0f}, "
        f"stalls {snap['serve.stalls']:.0f}, expired "
        f"{snap['serve.expired']:.0f}; {steps} decode steps + {chunks} "
        f"{'chunks' if paged else 'prefills'} dispatched, launches {got} "
        f"(replays counted), the same in the replay, which built nothing; "
        f"programs {progs}; storm wall {res['wall_s']:.2f} s (builds "
        f"included) on {smi}")
    log(f"{label} virtual clock (0.01 s a pump; not times of the card): "
        f"ttft_ms p50 {snap['serve.ttft_ms_p50']} p99 "
        f"{snap['serve.ttft_ms_p99']} itl_ms p50 {snap['serve.itl_ms_p50']}")
    return dict(res, first=first, free=free), {
        k: launches.get(k, 0) + replay.get(k, 0)
        for k in set(launches) | set(replay)}


def fe_async(sched, reqs) -> tuple:
    """Serve ``reqs`` through the asyncio loop on ``time.monotonic``:
    every stream consumed as its tokens come."""
    import asyncio
    from repro_torch.serve import ServeFrontend

    async def scenario():
        fe = ServeFrontend(sched)
        await fe.start()
        hs = [fe.submit(r) for r in reqs]

        async def consume(h):
            return [t async for t in h.stream()]

        streams = await asyncio.gather(*(consume(h) for h in hs))
        results = {h.rid: await h.result() for h in hs}
        await fe.stop(drain=True)
        return fe, hs, streams, results

    return asyncio.run(scenario())


def fe_interrupted(sched, reqs):
    """The same requests, one handle cancelled once it has streamed 2
    tokens and the front end preempted once another has streamed 4."""
    import asyncio
    from repro_torch.ft import PreemptionHandler
    from repro_torch.serve import ServeFrontend

    async def first(h, n):
        got = []
        async for t in h.stream():
            got.append(t)
            if len(got) == n:
                break

    async def scenario():
        pre = PreemptionHandler(install=False)
        fe = ServeFrontend(sched, preemption=pre)
        await fe.start()
        hs = [fe.submit(r) for r in reqs]
        await first(hs[0], 2)
        hs[0].cancel()
        await first(hs[1], 4)
        pre.request_stop()
        results = {h.rid: await h.result() for h in hs}
        await fe.stop()
        return results

    return asyncio.run(scenario())


def frontend_phase(smi: str) -> dict[str, int]:
    """Phase 14; returns its kernels' launches (the storms, replays and
    fault-free runs included)."""
    import gc
    import torch
    from repro_torch.kernels import registry
    from repro_torch.serve import synthetic_workload
    t0 = time.perf_counter()
    launches: dict[str, int] = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    res, storm = fe_storm(FE_ARGS + ["--deadline-ms", FE_DEADLINE_MS],
                          "pum", smi)
    add(storm)
    partial = [rid for rid, (st, _, toks) in res["first"].items()
               if st == "expired" and toks]
    if not partial:
        raise AssertionError(f"frontend paged pum: no request expired "
                             f"mid-decode: {res['first']}")
    log(f"frontend paged pum: expired mid-decode with a truncated prefix: "
        f"{ {rid: len(res['first'][rid][2]) for rid in partial} } tokens")
    sched = res["scheduler"]
    # 14b: phase 4's six requests in real time
    reqs = synthetic_workload(6, sched.cfg.vocab_size, min_prompt=20,
                              max_prompt=64, max_new=16, seed=0)
    free = timed_run(sched, reqs)           # builds the six's chunks too
    add(free["launches"])
    registry.reset_launches()
    before = sched.decode_steps, sched.prefill_chunks
    fe, hs, streams, results = fe_async(sched, reqs)
    torch.cuda.synchronize()
    launch_gate("pum", sched.cfg, sched.decode_steps - before[0],
                sched.prefill_chunks - before[1], registry.LAUNCHES)
    add(registry.LAUNCHES)
    for h, stream in zip(hs, streams):
        r = results[h.rid]
        if not r.ok or stream != r.tokens or r.tokens != free["tokens"][
                h.rid]:
            raise AssertionError(f"frontend async: rid {h.rid} {r.status} "
                                 f"stream {stream} result {r.tokens} "
                                 f"fault-free {free['tokens'][h.rid]}")
    fe_clean(sched, "frontend async")
    snap = fe.metrics.snapshot()
    log(f"frontend async wall clock (time.monotonic, phase 4's 6 requests "
        f"x 16 tokens, 4 slots, graphs): ttft_ms p50 "
        f"{snap['serve.ttft_ms_p50']:.3f} p99 {snap['serve.ttft_ms_p99']:.3f}"
        f", itl_ms p50 {snap['serve.itl_ms_p50']:.3f} p99 "
        f"{snap['serve.itl_ms_p99']:.3f}, tokens_per_s "
        f"{snap['serve.tok_per_s']:.2f} ({snap['serve.tokens']:.0f} "
        f"tokens; the fault-free sched.run before it, building the six's "
        f"chunk steps: {free['tokens_per_s']:.2f}) on {smi}")
    registry.reset_launches()
    interrupted = fe_interrupted(sched, reqs)
    fe_outcomes(interrupted, free["tokens"], "frontend interrupted")
    st = {rid: (r.status, len(r.tokens)) for rid, r in interrupted.items()}
    if st[0][0] != "cancelled" or st[0][1] < 2 or any(
            s not in ("ok", "cancelled") for s, _ in st.values()):
        raise AssertionError(f"frontend interrupted: {st}")
    fe_clean(sched, "frontend interrupted")
    add(registry.LAUNCHES)
    log(f"frontend interrupted (a handle cancelled after 2 tokens, "
        f"request_stop after 4 of another): {st}")
    del res, sched, fe, hs
    gc.collect()
    torch.cuda.empty_cache()
    log(f"frontend: paged in {time.perf_counter() - t0:.1f} s of the phase")
    # 14c: contiguous windows, int8, no chunk to fault
    res, storm = fe_storm(FE_CONTIG_ARGS, "int8", smi, cfg=contig_cut(),
                          paged=False)
    add(storm)
    if res["snapshot"]["serve.faults"] != res["frontend"].chaos.injected:
        raise AssertionError("frontend contiguous: a fault not absorbed")
    del res
    gc.collect()
    torch.cuda.empty_cache()
    log(f"frontend: phase 14 in {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 15: training
# ---------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ = 4, 128
TRAIN_ROWS = TRAIN_BATCH * TRAIN_SEQ     # M of every projection of a step
TRAIN_MODES = ("pum", "int8", "bf16")
TRAIN_STEPS = 6          # a mode's run on one repeated batch
TRAIN_WARMUP = 2         # steps left out of the median step time
TRAIN_LR = 1e-3
TRAIN_CUT = 2            # layers of Qwen2.5-3B in the parity checks
# bits a plane of K2's unpacked entry, by mode: pum slices the weight
# into 4 planes of 2 bits, int8 keeps it one plane of 8
TRAIN_SLICING = {"pum": 2, "int8": 8}
PROJ_PER_LAYER = sum(MVM_PER_LAYER.values())          # 7
# two microbatches against one batch (f32 activations, bf16 mode: no
# quantiser to flip): every gradient element within this share of the
# largest, summation-order round-off of sums over 256 and 512 rows
MICRO_TOL = 1e-4


def check_train_mvm(dev, gpu_name: str) -> list[dict]:
    """K2's unpacked entry (``bitslice_mvm``: the int32 weight sliced
    into planes per call, as the raw-weight forwards of ``pum`` and
    ``int8`` call it in training) at Qwen2.5-3B's four projection shapes
    at M = TRAIN_ROWS, in both slicings: bit for bit against its plain
    version, two calls bit-equal, timed (the weight rotated past the L2
    cache, as 36 layers' weights pass between two uses of one) beside
    its bound and ``torch._int_mm`` on the same int8 operands.  The
    inputs are what the forward hands it: int32 activation codes and
    the int32 quantised weight."""
    import torch
    from repro_torch.kernels.bitslice_mvm import ops
    bw, _, int8_rate = peaks(gpu_name)
    g = torch.Generator(device=dev).manual_seed(15)
    m = TRAIN_ROWS
    rows = []
    step = {mode: [0.0, 0.0] for mode in TRAIN_SLICING}
    for (k, n), per_layer in MVM_PER_LAYER.items():
        x = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                          dtype=torch.int32)
        wq = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                           dtype=torch.int32)
        rw = Rotating(lambda: wq.clone(), 4 * wq.numel())
        xl, wl = x.to(torch.int8), wq.to(torch.int8)
        rl = Rotating(lambda: wl.clone(), wl.numel())
        lib = device_ms(lambda: torch._int_mm(xl, rl.next()), iters=10)
        for mode, bps in TRAIN_SLICING.items():
            def call(backend, w=None, bps=bps):
                return ops.bitslice_mvm(x, wq if w is None else w,
                                        weight_bits=8, bits_per_slice=bps,
                                        backend=backend)

            got, want = call("cuda"), call("torch")
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            if not torch.equal(got, want) or not deterministic(
                    lambda: call("cuda")):
                raise AssertionError(f"bitslice_mvm (unpacked, {mode}) at "
                                     f"M={m} K={k} N={n}: max|diff| {err}, "
                                     f"or two calls differ")
            t = device_ms(lambda: call("cuda", rw.next()), iters=10)
            p = device_ms(lambda: call("torch", rw.next()), iters=3, reps=2)
            s = 4 if bps == 2 else 1
            by_bytes = (4 * m * k + 4 * k * n + 4 * m * n) / bw * 1e3
            by_ops = mvm_ops(m, k, n) / int8_rate * 1e3
            bound = max(by_bytes, by_ops)
            launches = 2 * LAYERS * per_layer
            step[mode][0] += launches * t
            step[mode][1] += launches * bound
            log(f"train mvm {mode} M={m} K={k} N={n} S={s}: exact, two "
                f"calls bit-equal | kernel {t:.4f} ms (plain {p:.4f}, "
                f"bound {bound:.4f}, {share(bound, t)} of bound) | "
                f"_int_mm {lib:.4f} ms | {launches} launches a step")
            rows.append(dict(shape=f"{mode} M={m} K={k} N={n} S={s}",
                             launches_per_step=launches, max_abs_err=err,
                             ms=t, plain_ms=p, bound_ms=bound,
                             bound_by="bytes" if by_bytes >= by_ops
                             else "operations", library_ms=lib))
        del x, wq, rw, rl, xl, wl
    for mode, (ms, bound) in step.items():
        log(f"train mvm {mode}: K2 over a step's "
            f"{2 * LAYERS * PROJ_PER_LAYER} launches (forward and remat) of "
            f"Qwen2.5-3B at M={m}, summed from the calls above: {ms:.2f} ms "
            f"(bound {bound:.2f} ms)")
    return rows


def step_profile(run, host: bool = False) -> tuple:
    """``run()`` under ``torch.profiler``: (device us by kernel name, and
    with ``host`` the host's top operators by self time, else None).
    The host's side costs the profiler some 20 s a full-width step, the
    card's alone a few."""
    import collections
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU]
                                            if host else [])
    with profile(activities=activities) as prof:
        run()
        torch.cuda.synchronize()
    by_name: collections.Counter[str] = collections.Counter()
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            by_name[evt.name] += evt.time_range.elapsed_us()
    if not host:
        return by_name, None
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return by_name, ", ".join(f"{e.key} {e.self_cpu_time_total / 1e3:.1f} "
                              f"ms x {e.count}" for e in ops[:8])


def train_cfg(mode: str, layers: int | None = None, arch="qwen2.5-3b",
              **kw):
    from repro_torch import configs
    from repro_torch.config import PUMConfig
    cfg = configs.get(arch)
    return cfg.replace(pum=PUMConfig(mode=mode),
                       num_layers=layers or cfg.num_layers, **kw)


def fixed_batch(cfg, dev, seed: int = 0) -> dict:
    """``SyntheticTokens``' first batch of B x S tokens, on the card."""
    import torch
    from repro_torch.data import SyntheticTokens
    toks = SyntheticTokens(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=seed).batch(0)
    return {"tokens": torch.from_numpy(toks["tokens"]).to(dev)}


def grads_equal(a, b) -> bool:
    """Loss metrics and gradient trees of two ``value_and_grad`` calls
    equal bit for bit."""
    import torch
    from repro_torch.tree import leaves
    return (a[0].keys() == b[0].keys()
            and all(torch.equal(a[0][k], b[0][k]) for k in a[0])
            and all(torch.equal(x, y) for x, y in zip(leaves(a[1]),
                                                      leaves(b[1]))))


def counted(fn):
    """(fn(), the kernel launches it made)."""
    import torch
    from repro_torch.kernels import registry
    registry.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(registry.LAUNCHES)


def train_parity(dev) -> None:
    """At Qwen2.5-3B's widths cut to TRAIN_CUT layers: a quantised loss
    and its gradients (remat on) launch exactly 7 K2 a layer in the
    forward and 7 more in the recomputation, and nothing else; the
    ``torch`` backend (the plain K2, the recomputation in the backward's
    own thread included) launches nothing and gives the same loss and
    gradients bit for bit; remat off launches 7 a layer and gives them
    bit for bit too; two microbatches equal one batch within MICRO_TOL."""
    import torch
    from repro_torch.config import ShardingConfig, TrainConfig
    from repro_torch.kernels import registry
    from repro_torch.models import lm
    from repro_torch.train import step as tstep
    from repro_torch.tree import leaves
    want = {"bitslice_mvm": 2 * PROJ_PER_LAYER * TRAIN_CUT}
    for mode in TRAIN_SLICING:
        cfg = train_cfg(mode, TRAIN_CUT)
        params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(
            1), dev)
        batch = fixed_batch(cfg, dev, seed=1)

        def grads(scfg=ShardingConfig()):
            return tstep.value_and_grad(tstep.make_loss_fn(cfg, scfg),
                                        params, batch)

        ref, n = counted(grads)
        if n != want:
            raise AssertionError(f"train {mode}: a loss and its gradients "
                                 f"launched {n}, want {want}")
        with registry.use_backend("torch"):
            plain, n = counted(grads)
        if n or not grads_equal(ref, plain):
            raise AssertionError(f"train {mode}: the torch backend launched "
                                 f"{n}, or its loss and gradients differ "
                                 f"from the cuda backend's")
        flat, n = counted(lambda: grads(ShardingConfig(remat="none")))
        if n != {"bitslice_mvm": PROJ_PER_LAYER * TRAIN_CUT} or \
                not grads_equal(ref, flat):
            raise AssertionError(f"train {mode}: remat off launched {n}, or "
                                 f"its loss and gradients differ from remat "
                                 f"on")
        log(f"train {mode} at {TRAIN_CUT} layers: {want['bitslice_mvm']} K2 "
            f"launches (forward + recomputation), none else; cuda == torch "
            f"backend and remat on == off, loss "
            f"{float(ref[0]['loss']):.6f} and every gradient bit for bit")
        del params, ref, plain, flat
    # microbatches, bf16 mode with f32 activations
    cfg = train_cfg("bf16", TRAIN_CUT, dtype="float32")
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(2),
                            dev)
    batch = fixed_batch(cfg, dev, seed=2)
    full = tstep.make_grad_fn(cfg, TrainConfig())(params, batch)
    micro = tstep.make_grad_fn(cfg, TrainConfig(
        microbatch=TRAIN_BATCH // 2))(params, batch)
    gmax = max(float(g.abs().max()) for g in leaves(full[0]))
    worst = max(float((a - b).abs().max())
                for a, b in zip(leaves(micro[0]), leaves(full[0]))) / gmax
    dloss = abs(float(micro[1]["loss"]) - float(full[1]["loss"]))
    log(f"train microbatches: 2 x {TRAIN_BATCH // 2} against {TRAIN_BATCH} "
        f"rows at {TRAIN_CUT} layers (bf16 mode, f32 activations): max "
        f"|dg| / max |g| = {worst:.3g} (bound {MICRO_TOL:g}), |dloss| = "
        f"{dloss:.3g}")
    if not worst <= MICRO_TOL or not dloss <= MICRO_TOL * abs(
            float(full[1]["loss"])):
        raise AssertionError("train: two microbatches differ from one batch "
                             "past the f32 bound")


def train_run(mode: str, dev, smi: str, tmp: str, host: bool = False
              ) -> tuple[dict, dict]:
    """Qwen2.5-3B at full width and depth, ``Trainer`` on one repeated
    batch of TRAIN_BATCH x TRAIN_SEQ tokens for TRAIN_STEPS steps
    (constant rate after a 1-step warm-up, remat on, f32 params,
    gradients, m and v).  Gated: a quantised step launches exactly 14 K2
    a layer (7 forward, 7 recomputed) and nothing else, bf16 mode none;
    every loss and gradient norm finite and the last loss below the
    first; every param finite after.  Returns (launches, figures)."""
    import torch
    from repro_torch.config import TrainConfig
    from repro_torch.train import Trainer
    from repro_torch.tree import leaves
    cfg = train_cfg(mode)
    tcfg = TrainConfig(steps=TRAIN_STEPS, learning_rate=TRAIN_LR,
                       warmup_steps=1, schedule="constant",
                       ckpt_every=10 ** 9, ckpt_dir=tmp)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, tcfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                      device=dev)
    batch = trainer.data.batch(0)
    trainer.data.batch = lambda step: batch        # one repeated batch
    out, launches = counted(trainer.run)
    wall = time.perf_counter() - t0
    per_step = 2 * PROJ_PER_LAYER * cfg.num_layers
    want = {"bitslice_mvm": TRAIN_STEPS * per_step} if mode != "bf16" else {}
    if launches != want:
        raise AssertionError(f"train {mode}: {TRAIN_STEPS} steps launched "
                             f"{launches}, want {want}")
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    if not all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
               for h in hist) or not losses[-1] < losses[0]:
        raise AssertionError(f"train {mode}: losses {losses} (grad norms "
                             f"{[h['grad_norm'] for h in hist]})")
    params, opt = out["params"], out["opt_state"]
    if not all(bool(torch.isfinite(p).all()) for p in leaves(params)):
        raise AssertionError(f"train {mode}: a param is not finite")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    mem = torch.cuda.memory_stats()
    times = sorted(h["step_time_s"] for h in hist[TRAIN_WARMUP:])
    step_ms = 1e3 * times[len(times) // 2]
    # one more step under the profiler: K2's device time in it, and the
    # host's busiest operators
    tb = {"tokens": torch.from_numpy(batch["tokens"]).to(dev)}
    t1 = time.perf_counter()
    by_name, ops = step_profile(lambda: trainer.train_step(params, opt,
                                                           tb), host)
    k2_ms = sum(us for name, us in by_name.items()
                if "bitslice" in name) / 1e3
    dev_ms = sum(by_name.values()) / 1e3
    log(f"train {mode}: allocator since the process began: "
        f"{mem['num_alloc_retries']} retries, {mem['num_device_alloc']} "
        f"cudaMalloc, {mem['num_device_free']} cudaFree, reserved peak "
        f"{mem['reserved_bytes.all.peak'] / 2 ** 30:.2f} GiB; the profiled "
        f"step {time.perf_counter() - t1:.1f} s with the profiler"
        + (f"; host self time by operator: {ops}" if host else ""))
    n_params = sum(p.numel() for p in leaves(params))
    log(f"train {mode} ({smi}): Qwen2.5-3B full width, {cfg.num_layers} "
        f"layers, {n_params / 1e9:.3f} B params, B={TRAIN_BATCH} "
        f"S={TRAIN_SEQ}: losses {' '.join(f'{x:.4f}' for x in losses)}; "
        f"step {step_ms:.1f} ms (median of steps {TRAIN_WARMUP}-"
        f"{TRAIN_STEPS - 1}), {TRAIN_ROWS / step_ms * 1e3:.0f} tokens/s, "
        f"peak memory {peak:.2f} GiB; a profiled step: device "
        f"{dev_ms:.1f} ms, K2 {k2_ms:.2f} ms "
        f"({per_step if mode != 'bf16' else 0} launches), top: "
        f"{top_kernels(by_name)}; phase run {wall:.1f} s")
    figures = dict(step_ms=step_ms, tokens_per_s=TRAIN_ROWS / step_ms * 1e3,
                   peak_gib=peak, k2_device_ms=k2_ms, device_ms=dev_ms,
                   losses=losses)
    return launches, figures


class StopAfter:
    """A preemption handler that asks to stop at its ``n``-th poll (the
    trainer polls once a step, after it)."""

    def __init__(self, n: int):
        self.n = n

    @property
    def should_stop(self) -> bool:
        self.n -= 1
        return self.n <= 0


def train_resume(dev, tmp: str) -> None:
    """The reduced Qwen2.5-3B in ``pum`` on the card: a run stopped by
    the preemption flag after 3 of 6 steps and resumed from its
    checkpoint ends with the params and optimiser state of an
    uninterrupted run, bit for bit."""
    import os
    import torch
    from repro_torch import configs
    from repro_torch.config import PUMConfig, TrainConfig
    from repro_torch.train import Trainer
    from repro_torch.tree import leaves
    cfg = configs.get_reduced("qwen2.5-3b").replace(pum=PUMConfig(
        mode="pum"))

    def trainer(sub, preemption=None):
        tcfg = TrainConfig(steps=6, learning_rate=1e-2, warmup_steps=1,
                           ckpt_every=100, ckpt_dir=os.path.join(tmp, sub))
        return Trainer(cfg, tcfg, batch=4, seq=32, preemption=preemption,
                       device=dev)

    whole = trainer("whole").run()
    first = trainer("resumed", StopAfter(3)).run()
    second = trainer("resumed").run()
    a = leaves([whole["params"], whole["opt_state"]])
    b = leaves([second["params"], second["opt_state"]])
    if not (first["stopped_early"] and first["last_step"] == 3
            and second["last_step"] == 6 and len(a) == len(b)
            and all(torch.equal(x, y) for x, y in zip(a, b))):
        raise AssertionError("train resume: the resumed run's params and "
                             "optimiser state differ from the whole run's")
    log(f"train resume: stopped at step 3, resumed to 6 from its "
        f"checkpoint: params, m, v and count bit-equal to an unbroken run "
        f"({len(a)} leaves)")


def train_moe(dev, smi: str) -> dict[str, int]:
    """OLMoE-1B-7B at full width cut to 2 of its 16 layers, ``pum``: one
    train step through the router, the experts (float) and the aux
    losses; the router's gradient finite and non-zero in both layers,
    the total loss the NLL plus the weighted aux losses."""
    import torch
    from repro_torch.config import TrainConfig
    from repro_torch.models import lm
    from repro_torch.train import step as tstep
    cfg = train_cfg("pum", 2, arch="olmoe-1b-7b")
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(3),
                            dev)
    batch = fixed_batch(cfg, dev, seed=3)
    (metrics, grads), launches = counted(lambda: tstep.value_and_grad(
        tstep.make_loss_fn(cfg), params, batch))
    routers = [blk["moe"]["router"]["w"] for blk in grads["blocks"]]
    lb = float(metrics.get("moe_lb", float("nan")))
    if not (math.isfinite(lb) and float(metrics["total_loss"])
            > float(metrics["loss"]) + tstep.MOE_LB_WEIGHT * lb
            and all(bool(torch.isfinite(r).all()) and float(r.abs().max()) > 0
                    for r in routers)):
        raise AssertionError(f"train moe: metrics {metrics}, router grads "
                             f"finite and non-zero: "
                             f"{[float(r.abs().max()) for r in routers]}")
    tcfg = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=1)
    opt = tstep.init_opt_state(params, tcfg)
    t0 = time.perf_counter()
    _, _, m = tstep.make_train_step(cfg, tcfg)(params, opt, batch)
    torch.cuda.synchronize()
    if not math.isfinite(float(m["total_loss"])):
        raise AssertionError(f"train moe: step metrics {m}")
    log(f"train moe ({smi}): OLMoE-1B-7B, 2 of 16 layers, B={TRAIN_BATCH} "
        f"S={TRAIN_SEQ}: loss {float(metrics['loss']):.4f} moe_lb {lb:.4f} "
        f"total {float(metrics['total_loss']):.4f}; router |grad| max "
        f"{', '.join(f'{float(r.abs().max()):.3g}' for r in routers)}; "
        f"{launches} launches for a loss and its gradients; a step "
        f"{1e3 * (time.perf_counter() - t0):.0f} ms")
    return launches


def train_phase(dev, smi: str, host: bool = False
                ) -> tuple[dict[str, int], dict[str, dict]]:
    """Phase 15 under deterministic algorithms (the embedding's and the
    MoE gathers' backward sum without atomics); returns K2's launches on
    the main path (the full-width runs) and each mode's figures.
    ``host`` (``--profile-host``) adds the host's side to each profiled
    step."""
    import gc
    import shutil
    import tempfile
    import torch
    t0 = time.perf_counter()
    torch.use_deterministic_algorithms(True)
    # every kernel output is written whole: no NaN fill of torch.empty
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.utils.deterministic.fill_uninitialized_memory = False
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    launches: dict[str, int] = {}
    figures = {}
    try:
        train_parity(dev)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"train: parity checks in {time.perf_counter() - t0:.1f} s")
        for mode in TRAIN_MODES:
            n, figures[mode] = train_run(mode, dev, smi,
                                         os.path.join(tmp, mode), host)
            for k, v in n.items():
                launches[k] = launches.get(k, 0) + v
            gc.collect()
            torch.cuda.empty_cache()
        t1 = time.perf_counter()
        train_resume(dev, tmp)
        log(f"train: resume in {time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        train_moe(dev, smi)
        log(f"train: moe in {time.perf_counter() - t1:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill
    log(f"train: phase 15 in {time.perf_counter() - t0:.1f} s")
    return launches, figures


# ---------------------------------------------------------------------------
# Phase 16: the paper's LLM encoder with I-BERT (paper §5.2)
# ---------------------------------------------------------------------------

# RoBERTa-base's published widths (Liu et al. 2019), the model I-BERT was
# evaluated on (Kim et al., ICML 2021), in the app's own structure (post-LN,
# no biases, a 2048-row position table), at B x S = 8 x 512 (M = 4096)
ENC = dict(layers=12, d_model=768, d_ff=3072, heads=12, vocab=50265)
ENC_BATCH, ENC_SEQ = 8, 512
# its projections by (K, N), counted over a layer: q, k, v, o; the FFN's
# up and down: 72 launches a forward
ENC_MVM = {(768, 768): 4, (768, 3072): 1, (3072, 768): 1}
ENC_LAUNCHES = ENC["layers"] * sum(ENC_MVM.values())
# (label, mode, prepacked) and the one MVM kernel each forward launches:
# K1 on pum's packed planes, K2 on int8's packed weight and on both
# modes' raw weights (its unpacked entry); bf16 none
ENC_RUNS = [("pum", "pum", True, "bitslice_mvm_scaled"),
            ("int8", "int8", True, "bitslice_mvm"),
            ("pum raw", "pum", False, "bitslice_mvm"),
            ("int8 raw", "int8", False, "bitslice_mvm"),
            ("bf16", "bf16", False, None)]
# the I-BERT functions at the encoder's shapes: (function, the float one it
# replaces, input shape, the input's spread, calls a forward); the scores'
# spread keeps the integer softmax's rows non-zero (its reciprocal
# 2^15 // sum is 0 once a row's exponential codes sum past 2^15, as at
# 512 keys of unit spread)
IBERT_SHAPES = [
    ("softmax_quantized", "softmax", (ENC_BATCH, ENC["heads"], ENC_SEQ,
                                      ENC_SEQ), 4.0, ENC["layers"]),
    ("gelu_quantized", "gelu", (ENC_BATCH, ENC_SEQ, ENC["d_ff"]), 1.0,
     ENC["layers"]),
    ("layernorm_quantized", "layernorm", (ENC_BATCH, ENC_SEQ,
                                          ENC["d_model"]), 1.5,
     2 * ENC["layers"]),
]
IBERT_RANGES = {"_softmax": "ibert_softmax", "_gelu": "ibert_gelu",
                "_layernorm": "ibert_layernorm"}
# phase 16's Qwen2.5-3B under pum.ibert: through the paged CLI at full
# width, cut to this many of its 36 layers (every gate compares runs of
# one config)
IBERT_QWEN_LAYERS = 6


def check_encoder_mvm(dev) -> dict[str, list[dict]]:
    """Phase 3's checks at the encoder's shapes: K1 and K2 at M = 4096
    (768x768, 768x3072, 3072x768), bit for bit, two calls bit-equal,
    timed beside their bounds and ``torch._int_mm``; each row says which
    of its bounds (bytes or operations) is the larger."""
    import torch
    bw, _, int8_rate = peaks(torch.cuda.get_device_name(dev))
    m = ENC_BATCH * ENC_SEQ
    cases = mvm_sweep(dev, {s: ENC["layers"] * c for s, c in
                            ENC_MVM.items()}, ENC["layers"],
                      "the encoder at RoBERTa-base's widths", [m])
    out: dict[str, list[dict]] = {"bitslice_mvm_scaled": [],
                                  "bitslice_mvm": []}
    for case in cases:
        for name, kern, planes in (("bitslice_mvm_scaled", "K1", 4),
                                   ("bitslice_mvm", "K2", 1)):
            row = dict(case[kern])
            k, n = row["K"], row["N"]
            by_bytes = (m * k + planes * k * n + 4 * m * n
                        + (4 * m if planes > 1 else 0)) / bw
            by_ops = mvm_ops(m, k, n) / int8_rate
            row["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
            row["launches_per_forward"] = ENC["layers"] * ENC_MVM[(k, n)]
            out[name].append(row)
    return out


def ibert_functions(dev, smi: str) -> None:
    """Each I-BERT function at the encoder's shapes on f32 inputs drawn
    from a seed: on the card bit-equal to the CPU (the same integer ops,
    the same f32 scale arithmetic), two calls bit-equal; its device time
    (a CUDA graph of 5 calls) beside its byte bound (the f32 input read
    once, the f32 output written once) and the float function it
    replaces."""
    import torch
    import torch.nn.functional as F
    from repro_torch.apps import encoder_app as tenc
    from repro_torch.config import PUMConfig
    from repro_torch.core import ibert
    bw, _, _ = peaks(torch.cuda.get_device_name(dev))
    g = torch.Generator(device=dev).manual_seed(16)
    floats = {"softmax": lambda x: torch.softmax(x, -1),
              "gelu": lambda x: F.gelu(x),
              "layernorm": lambda x: tenc._layernorm(
                  x, PUMConfig(mode="bf16"))}
    for fn, flt, shape, spread, calls in IBERT_SHAPES:
        x = torch.randn(shape, generator=g, device=dev) * spread
        f = getattr(ibert, fn)
        got = f(x)
        torch.cuda.synchronize()
        want = f(x.cpu())
        if not torch.equal(got.cpu(), want) or not deterministic(
                lambda: f(x)):
            raise AssertionError(
                f"{fn} at {list(shape)}: the card differs from the CPU "
                f"(max|diff| {(got.cpu() - want).abs().max().item():.3g}) "
                f"or two calls differ")
        ms = device_ms(lambda: f(x), iters=5, reps=3)
        plain = device_ms(lambda: floats[flt](x), iters=5, reps=3)
        bound = 8 * x.numel() / bw * 1e3
        log(f"ibert {fn} {list(shape)}: card == CPU bit for bit, two calls "
            f"bit-equal; {ms:.4f} ms (byte bound {bound:.4f}, "
            f"{share(bound, ms)} of bound; the float {flt} {plain:.4f} ms); "
            f"{calls} calls a forward: {calls * ms:.3f} ms on {smi}")
        del x, got, want


def encoder_split(run) -> str:
    """One ``run()`` under the profiler with the app's three I-BERT
    functions in ranges of their own: the device ms of K1, the attention
    einsums' GEMMs, each I-BERT function and the rest."""
    import collections
    import contextlib
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.apps import encoder_app as tenc
    saved = {name: getattr(tenc, name) for name in IBERT_RANGES}

    def ranged(name, f):
        def g(*a, **kw):
            with record_function(IBERT_RANGES[name]):
                return f(*a, **kw)
        return g

    with contextlib.ExitStack() as stack:
        stack.callback(lambda: [setattr(tenc, k, v)
                                for k, v in saved.items()])
        for name, f in saved.items():
            setattr(tenc, name, ranged(name, f))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
    # a range's device time is the sum of the kernels its ops launched
    # (its span on the device would count the gaps between them)
    kernels: dict[str, float] = {}
    ranges = dict.fromkeys(IBERT_RANGES.values(), 0.0)
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            if evt.name not in ranges:
                kernels[evt.name] = (kernels.get(evt.name, 0.0)
                                     + evt.time_range.elapsed_us())
        elif evt.name in ranges:
            ranges[evt.name] += evt.device_time_total
    total = sum(kernels.values())
    if not total:
        return "not measured (the profiler saw no device time)"
    k1 = sum(us for k, us in kernels.items() if "bitslice" in k)
    gemm = sum(us for k, us in kernels.items()
               if "gemm" in k.lower() and "bitslice" not in k)
    ib = sum(ranges.values())
    parts = [("K1", k1), ("einsum GEMMs", gemm),
             *[(k, us) for k, us in ranges.items()],
             ("the rest", total - k1 - gemm - ib)]
    return (f"{total / 1e3:.2f} ms of kernels: " + ", ".join(
        f"{name} {us / 1e3:.2f} ms ({100 * us / total:.1f} %)"
        for name, us in parts) + "; top kernels: "
        + top_kernels(collections.Counter(kernels), 4))


def encoder_app_run(dev, smi: str) -> dict[str, int]:
    """The encoder at RoBERTa-base's widths on 8 x 512 tokens, weights
    from a seed on the card, in every mode of ``ENC_RUNS`` with I-BERT
    off and on.  Gated: a forward launches exactly ``ENC_LAUNCHES`` of
    its mode's MVM kernel and nothing else (K3 and K4 never); the
    ``torch`` backend's hidden states equal the ``cuda`` backend's bit
    for bit (K1/K2 are exact, and nothing else differs); two runs give
    the same bits; raw == prepacked in ``int8`` and ``pum``; finite.
    Printed: ms a forward and sequences/s, the cosine of I-BERT's hidden
    states with the float path's and the top-1 agreement of
    ``encoder_logits`` (``pum``, at 2 layers, the JAX test's depth, and
    at 12), the share of the I-BERT softmax's all-zero rows layer by
    layer, the profiler's split of a ``pum`` I-BERT forward.  Returns
    the launches of one forward a (mode, I-BERT) pair."""
    import torch
    from repro_torch.apps import encoder_app as tenc
    from repro_torch.config import PUMConfig
    from repro_torch.kernels import registry
    g = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = tenc.encoder_init(g, **ENC, device=dev)
    tokens = torch.randint(0, ENC["vocab"], (ENC_BATCH, ENC_SEQ),
                           generator=g, device=dev, dtype=torch.int32)
    packed = {mode: tenc.encoder_prepack(params, PUMConfig(mode=mode))
              for mode in ("pum", "int8")}
    torch.cuda.synchronize()
    log(f"encoder: RoBERTa-base widths {ENC}, tokens [{ENC_BATCH}, "
        f"{ENC_SEQ}], drawn and packed in {time.perf_counter() - t0:.2f} s")
    launches: dict[str, int] = {}
    hidden = {}
    for label, mode, pre, kernel in ENC_RUNS:
        for ib in (False, True):
            pum = PUMConfig(mode=mode, ibert=ib)
            p = packed[mode] if pre else params

            def fwd(p=p, pum=pum):
                with torch.inference_mode():
                    return tenc.encoder_apply(p, tokens, pum,
                                              heads=ENC["heads"])

            registry.reset_launches()
            h = fwd()
            torch.cuda.synchronize()
            counts = {k: v for k, v in registry.LAUNCHES.items() if v}
            want = {kernel: ENC_LAUNCHES} if kernel else {}
            again = fwd()
            with registry.use_backend("torch"):
                registry.reset_launches()
                plain = fwd()
                torch.cuda.synchronize()
                plain_counts = {k: v for k, v in registry.LAUNCHES.items()
                                if v}
            name = f"{label}{' ibert' if ib else ''}"
            gates = {
                f"launches {want}": counts == want,
                "the torch backend launches nothing": plain_counts == {},
                "cuda == torch bit for bit": torch.equal(h, plain),
                "two runs bit-equal": torch.equal(h, again),
                "finite": bool(torch.isfinite(h).all()),
                f"[{ENC_BATCH}, {ENC_SEQ}, {ENC['d_model']}] f32":
                    tuple(h.shape) == (ENC_BATCH, ENC_SEQ, ENC["d_model"])
                    and h.dtype == torch.float32,
            }
            failed = [k for k, ok in gates.items() if not ok]
            ms = event_ms(fwd, reps=3)
            log(f"encoder {name}: launches {counts}; {ms:.3f} ms a forward, "
                f"{1e3 * ENC_BATCH / ms:.1f} sequences/s "
                f"({1e3 * ENC_BATCH * ENC_SEQ / ms:.0f} tokens/s); "
                f"max|cuda - torch| {(h - plain).abs().max().item():.3g}; "
                f"gates failed: {failed} on {smi}")
            if failed:
                raise AssertionError(f"encoder {name}: {failed}")
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
            hidden[label, ib] = h
            del again, plain
    for mode in ("int8", "pum"):
        for ib in (False, True):
            if not torch.equal(hidden[mode, ib], hidden[f"{mode} raw", ib]):
                raise AssertionError(f"encoder {mode} (ibert {ib}): raw "
                                     f"and prepacked weights differ")
    agreement = []
    zero_rows: list[float] = []
    softmax = tenc._softmax

    def spy(x, pum):
        probs = softmax(x, pum)
        if pum.ibert:
            zero_rows.append(float((probs.sum(-1) == 0).float().mean()))
        return probs

    for depth in (2, ENC["layers"]):
        cut = dict(packed["pum"], layers=packed["pum"]["layers"][:depth])
        tenc._softmax = spy
        try:
            with torch.inference_mode():
                h = [tenc.encoder_apply(cut, tokens,
                                        PUMConfig(mode="pum", ibert=ib),
                                        heads=ENC["heads"]).double()
                     for ib in (False, True)]
        finally:
            tenc._softmax = softmax
            top = [tenc.encoder_logits(cut, tokens,
                                       PUMConfig(mode="pum", ibert=ib),
                                       heads=ENC["heads"]).argmax(-1)
                   for ib in (False, True)]
        cos = float((h[0] * h[1]).sum() / (h[0].norm() * h[1].norm()))
        agree = float((top[0] == top[1]).float().mean())
        agreement.append(f"{depth} layers: cosine of the hidden states "
                         f"{cos:.4f}, top-1 agreement of encoder_logits "
                         f"{agree:.4f}")
        del h, top
    log(f"encoder: raw == prepacked bit for bit in int8 and pum (I-BERT "
        f"off and on); pum I-BERT against pum float at "
        f"{'; at '.join(agreement)}; the I-BERT softmax's all-zero rows "
        f"(a row's exponential codes summing past 2^15), layer by layer "
        f"of the 12-layer forward: {zero_rows[2:]}")
    split = encoder_split(lambda: tenc.encoder_apply(
        packed["pum"], tokens, PUMConfig(mode="pum", ibert=True),
        heads=ENC["heads"]))
    log(f"encoder pum ibert forward under the profiler: {split} on {smi}")
    del hidden, params, packed
    return launches


def qwen_ibert(smi: str) -> dict[str, int]:
    """Qwen2.5-3B at full width cut to ``IBERT_QWEN_LAYERS`` layers under
    ``pum.ibert`` through the paged CLI on phase 4's trace (chunked
    prefill): its 252-per-36-layer MVM launches a step or chunk on K1
    and no K3 (the paged branch takes the I-BERT softmax in the plain
    composition); graphs == eager bit for bit on a chunk and a step; the
    ``cuda`` and ``torch`` backends' logits bit for bit (K3 is off the
    path and K1 is exact); finite.  Returns the CLI run's launches."""
    import gc
    import torch
    from repro_torch import configs
    from repro_torch.config import PUMConfig
    from repro_torch.kernels import registry
    from repro_torch.launch import serve
    cfg = configs.get("qwen2.5-3b").replace(
        num_layers=IBERT_QWEN_LAYERS, pum=PUMConfig(mode="pum", ibert=True))
    registry.reset_launches()
    res = serve.main(SERVE_ARGS + ["--pum-mode", "pum"], cfg=cfg)
    torch.cuda.synchronize()
    launches = {k: v for k, v in registry.LAUNCHES.items() if v}
    sched = res["scheduler"]
    mvm, _ = per_pass(sched.cfg)
    n = sched.decode_steps + sched.prefill_chunks
    want = {"bitslice_mvm_scaled": mvm * n}
    graph_vs_eager(sched)
    registry.reset_launches()
    a = chunk_and_step(sched, sched.params, "cuda")
    direct = {k: v for k, v in registry.LAUNCHES.items() if v}
    b = chunk_and_step(sched, sched.params, "torch")
    gates = {
        f"launches {want} ({mvm} K1 a step or chunk), no K3":
            launches == want,
        "the chunk and the step launch K1 alone": direct == {
            "bitslice_mvm_scaled": 2 * mvm},
        "cuda == torch logits bit for bit": torch.equal(a, b),
        "finite logits": bool(torch.isfinite(a).all()),
        "6 requests x 16 tokens": len(res["completions"]) == 6 and all(
            len(c.tokens) == 16 for c in res["completions"].values()),
    }
    failed = [k for k, ok in gates.items() if not ok]
    log(f"qwen2.5-3b pum ibert paged: {cfg.num_layers} of 36 layers, "
        f"{sched.decode_steps} decode steps + {sched.prefill_chunks} chunks; "
        f"launches {launches}; decode_ms_per_step {res['decode_ms']:.3f}; "
        f"programs {sched.step_programs()}; gates failed: {failed} on {smi}")
    if failed:
        raise AssertionError(f"qwen2.5-3b ibert: {failed}")
    del res, sched
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def encoder_phase(dev, smi: str) -> dict[str, int]:
    """Phase 16; returns each kernel's launches on its main paths."""
    import gc
    import torch
    t0 = time.perf_counter()
    launches: dict[str, int] = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    ibert_functions(dev, smi)
    add(encoder_app_run(dev, smi))
    gc.collect()
    torch.cuda.empty_cache()
    log(f"encoder: the app done at {time.perf_counter() - t0:.1f} s of the "
        f"phase")
    add(whisper_run(smi, ibert=True))
    add(qwen_ibert(smi))
    if launches.get("paged_attention") or launches.get("gf2_mvm") \
            or launches.get("gf2_mvm_packed"):
        raise AssertionError(f"phase 16 launched K3 or K4: {launches}")
    log(f"encoder: phase 16 in {time.perf_counter() - t0:.1f} s")
    return launches


KERNELS = {
    "bitslice_mvm_scaled": dict(
        route="cuda",
        source="src/repro_torch/kernels/bitslice_mvm/csrc/bitslice_mvm.cu",
        replaces="src/repro/kernels/bitslice_mvm/kernel.py:139"),
    "bitslice_mvm": dict(
        route="cuda",
        source="src/repro_torch/kernels/bitslice_mvm/csrc/bitslice_mvm.cu",
        replaces="src/repro/kernels/bitslice_mvm/kernel.py:98"),
    "paged_attention": dict(
        route="cuda",
        source="src/repro_torch/kernels/paged_attention/csrc/"
               "paged_attention.cu",
        replaces="src/repro/kernels/paged_attention/kernel.py:113"),
    "gf2_mvm": dict(
        route="cuda",
        source="src/repro_torch/kernels/gf2_mvm/csrc/gf2_mvm.cu",
        replaces="src/repro/kernels/gf2_mvm/kernel.py:41"),
    "gf2_mvm_packed": dict(
        route="cuda",
        source="src/repro_torch/kernels/gf2_mvm/csrc/gf2_mvm.cu",
        replaces="src/repro/kernels/gf2_mvm/kernel.py:41"),
}
# held against its plain version in phase 3 only: the AES rounds run the
# state-byte entry, and no other path calls K4's int8 entry
OFF_MAIN_PATH = {"gf2_mvm"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=["kernels", "cnn", "contiguous",
                                       "xlstm", "moe", "hybrid",
                                       "families", "frontend", "train",
                                       "encoder"],
                    default=None)
    ap.add_argument("--profile-host", action="store_true",
                    help="phase 15: profile the host's operators in each "
                         "mode's profiled step too (some 20 s a mode)")
    args = ap.parse_args(argv)

    start = time.perf_counter()
    # phase 15's bit-for-bit gates run cuBLAS under deterministic
    # algorithms, which needs its workspace fixed before the CUDA context
    # exists: the whole run takes it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs the "
              "card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    # -- 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    gpu_name = torch.cuda.get_device_name(0)
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    dev = torch.device("cuda", 0)

    # -- 2. build
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"build: {len(logs)} kernel sources in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    if args.only == "cnn":
        cnn_launches, cnn_rows = cnn_phase(dev, gpu_name, smi)
        log(json.dumps({"kernels": {"bitslice_mvm": {
            "launches": cnn_launches["bitslice_mvm"],
            "cnn_shapes": cnn_rows}}}))
        return 0

    if args.only == "contiguous":
        contig_launches, prefill_rows = contiguous_phase(dev, gpu_name, smi)
        log(json.dumps({"kernels": {"launches": contig_launches,
                                    "prefill_shape": prefill_rows}}))
        log(f"phase 9 done at {time.perf_counter() - start:.1f} s")
        return 0

    if args.only == "xlstm":
        cases = xlstm_rows(check_xlstm_mvm(dev))
        xlstm_launches = xlstm_phase(smi)
        log(json.dumps({"kernels": {"launches": xlstm_launches,
                                    "xlstm_shapes": cases}}))
        log(f"phase 10 done at {time.perf_counter() - start:.1f} s")
        return 0

    if args.only == "moe":
        cases = check_moe_kernels(dev, gpu_name)
        moe_launches = moe_phase(smi)
        log(json.dumps({"kernels": {"launches": moe_launches,
                                    "moe_shapes": cases}}))
        log(f"phase 11 done at {time.perf_counter() - start:.1f} s")
        return 0

    if args.only == "hybrid":
        cases = check_hybrid_kernels(dev, gpu_name)
        hybrid_launches = hybrid_phase(smi)
        log(json.dumps({"kernels": {"launches": hybrid_launches,
                                    "hybrid_shapes": cases}}))
        log(f"phase 12 done at {time.perf_counter() - start:.1f} s")
        return 0

    if args.only == "frontend":
        log(json.dumps({"kernels": {"launches": frontend_phase(smi)}}))
        log(f"phase 14 done at {time.perf_counter() - start:.1f} s")
        return 0

    if args.only == "train":
        cases = check_train_mvm(dev, gpu_name)
        train_launches, _ = train_phase(dev, smi, args.profile_host)
        log(json.dumps({"kernels": {"launches": train_launches,
                                    "train_shapes": cases}}))
        log(f"phase 15 done at {time.perf_counter() - start:.1f} s")
        return 0

    if args.only == "encoder":
        cases = check_encoder_mvm(dev)
        encoder_launches = encoder_phase(dev, smi)
        log(json.dumps({"kernels": {"launches": encoder_launches,
                                    "encoder_shapes": cases}}))
        log(f"phase 16 done at {time.perf_counter() - start:.1f} s")
        return 0

    if args.only == "families":
        cases = check_family_kernels(dev, gpu_name)
        family_launches = families_phase(smi)
        log(json.dumps({"kernels": {"launches": family_launches,
                                    "family_shapes": cases}}))
        log(f"phase 13 done at {time.perf_counter() - start:.1f} s")
        return 0

    # -- 3. kernels
    rows = check_mvm(dev)
    for name, cases in xlstm_rows(check_xlstm_mvm(dev)).items():
        rows[name]["xlstm_shapes"] = cases
    rows["paged_attention"] = attention_row(check_attention(dev, gpu_name))
    rows["paged_attention"]["verify_shape"] = check_attention(
        dev, gpu_name, cases=[(SPEC_K + 1, 81)])[0]
    check_row_invariance(dev, smi)
    check_shared_cols(dev)
    for name, cases in check_moe_kernels(dev, gpu_name).items():
        rows[name]["moe_shapes"] = cases
    for name, cases in check_hybrid_kernels(dev, gpu_name).items():
        rows[name]["hybrid_shapes"] = cases
    for name, cases in check_family_kernels(dev, gpu_name).items():
        rows[name]["family_shapes"] = cases
    rows["bitslice_mvm"]["train_shapes"] = check_train_mvm(dev, gpu_name)
    for name, cases in check_encoder_mvm(dev).items():
        rows[name]["encoder_shapes"] = cases
    rows.update(check_gf2(dev, gpu_name))
    if args.only == "kernels":
        log(json.dumps({"kernels": rows}))
        return 0

    log(f"phases 1-3 done at {time.perf_counter() - start:.1f} s")
    launches, greedy = serve_phases(smi)
    log(f"phases 4-5b done at {time.perf_counter() - start:.1f} s")
    for k, v in aes_phase(dev, smi).items():
        launches[k] = launches.get(k, 0) + v
    log(f"phase 6 done at {time.perf_counter() - start:.1f} s")
    cnn_launches, rows["bitslice_mvm"]["cnn_shapes"] = cnn_phase(
        dev, gpu_name, smi)
    for k, v in cnn_launches.items():
        launches[k] = launches.get(k, 0) + v
    log(f"phase 7 done at {time.perf_counter() - start:.1f} s")
    for k, v in sampled_phase(greedy, smi).items():
        launches[k] = launches.get(k, 0) + v
    log(f"phase 8 done at {time.perf_counter() - start:.1f} s")
    contig_launches, prefill_rows = contiguous_phase(dev, gpu_name, smi)
    for k, v in contig_launches.items():
        launches[k] = launches.get(k, 0) + v
    for name, row in prefill_rows.items():
        rows[name]["prefill_shape"] = row
    log(f"phase 9 done at {time.perf_counter() - start:.1f} s")
    for k, v in xlstm_phase(smi).items():
        launches[k] = launches.get(k, 0) + v
    log(f"phase 10 done at {time.perf_counter() - start:.1f} s")
    for k, v in moe_phase(smi).items():
        launches[k] = launches.get(k, 0) + v
    log(f"phase 11 done at {time.perf_counter() - start:.1f} s")
    for k, v in hybrid_phase(smi).items():
        launches[k] = launches.get(k, 0) + v
    log(f"phase 12 done at {time.perf_counter() - start:.1f} s")
    for k, v in families_phase(smi).items():
        launches[k] = launches.get(k, 0) + v
    log(f"phase 13 done at {time.perf_counter() - start:.1f} s")
    for k, v in frontend_phase(smi).items():
        launches[k] = launches.get(k, 0) + v
    log(f"phase 14 done at {time.perf_counter() - start:.1f} s")
    for k, v in train_phase(dev, smi, args.profile_host)[0].items():
        launches[k] = launches.get(k, 0) + v
    log(f"phase 15 done at {time.perf_counter() - start:.1f} s")
    for k, v in encoder_phase(dev, smi).items():
        launches[k] = launches.get(k, 0) + v
    log(f"phase 16 done at {time.perf_counter() - start:.1f} s")
    out = []
    for name, meta in KERNELS.items():
        n = launches.get(name, 0)
        main_path = name not in OFF_MAIN_PATH
        if main_path and n <= 0:
            raise AssertionError(f"{name} never launched on the main path")
        if not main_path and n:
            raise AssertionError(f"{name} launched {n} times on the main "
                                 f"path, which should not call it")
        out.append({"name": name, **meta, "launches": n,
                    "main_path": main_path, **rows[name]})
    log(json.dumps({"kernels": out}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": gpu_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
