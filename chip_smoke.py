#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
CUDA toolkit.  Phases, each fatal on failure:

1. device: the card's name and power limit, as nvidia-smi reports them;
2. build: ``nvcc`` compiles ``src/repro_torch/csrc/*.cu`` into one
   library (its wall time printed); each kernel's registers, static
   shared memory and spills from the ``-Xptxas -v`` log, and its
   tensor-core instructions (HGMMA, HMMA) from ``cuobjdump -sass`` where
   the toolkit has it; fails if the bf16 flash or bf16 prefix-prefill
   kernel, the f32 flash forward (3xTF32), the flash backward (every
   f32 and bf16 instance), either SSD scan kernel (C.B^T and the
   scan, every instance) or a kernel of the scan's backward (chain,
   chunk, db/dc; every instance) has none, or if a kernel of the
   scan's backward spills; then the host's µs to call one dense decode
   launch through its registered op, through the wrapper and through
   ``kernel.py`` directly (every launch below goes through its op,
   ``repro_torch::<name>``);
3. kernels: each hand-written kernel against its plain PyTorch version
   on the card, on chatglm-6b's shapes, GQA shapes and edge shapes, in
   f32 (TF32 off, tolerance 2e-4) and bf16 (5e-2): paged decode with
   lengths around a page, split-KV (B 1-2, lengths 640+), G > 8 in head
   chunks and D 32/64/128 at bt 8/16/32; prefix prefill with and without
   cached prefixes, prefix lengths off the 64-key tile, two 64-row tiles
   of G = 3 and S > 64; then the poison cases (NaN or large values in pad
   pages, foreign pages, slots past a length and suffix keys past
   suffix_lens), which must change the output by exactly 0, in both
   dtypes; dense flash prefill in its causal, sliding-window and full
   masks; dense decode with mixed lengths and NaN written past them;
4. model: a reduced chatglm-6b in f32 on the card (kernels) against the
   same model on the CPU (plain versions): the paged model (an admission
   wave with hits, misses and copy-on-write, then decode steps) and the
   dense model (padded prefill, then a fused decode window);
5. paged serve: ``run_paged_engine_backend(..., reduced=False)``:
   chatglm-6b at full width (28 layers, d_model 4096) in bf16,
   ``magnus-paged`` with the prefix cache, on shared-instruction
   traffic.  Kernel launch counts are zeroed just before and read just
   after; every request must finish, the pool must drain, the prefix
   cache must hit and both paged kernels must have launched, the decode
   kernel once per layer and step and prefix prefill once per layer and
   wave, with one readback per decode window.  The engine captures its
   decode step as a CUDA graph at its first window (once), and every
   later step is a replay, whose launches the wrappers count.  The
   inputs of each decode step's and each admission wave's layer-0
   attention call are kept (a replayed step's from the tensors the
   graph captured).  Then one decode window of a fresh full wave is
   timed and profiled (device busy time, idle share, the kernels that
   take the time);
6. paged timings at the serve's own shapes: each kept decode step and
   wave is replayed through the kernel (held against its plain version),
   the plain version and a PyTorch library yardstick; each gets the
   median card time of its calls from CUDA events, and the least time
   the card could take for it (the bytes it must move at 3.35 TB/s, its
   operations at 989 TFLOP/s).  A kernel's numbers are the means over
   the serve's steps or waves, so they are per launch of the serve;
7. padded serve: ``run_engine_backend(..., reduced=False)``: chatglm-6b
   at full width in bf16, ``magnus``, through the paper's padded
   ``BatchEngine`` on 64 Poisson requests.  Counts are zeroed just
   before and read just after; every request must get its generation
   length, every batch must run G(B) iterations with one readback per
   power-of-two window, the flash kernel must launch once per layer and
   batch, the dense decode kernel once per layer and decode step, and no
   plain version may run.  Each batch of at least ``MIN_GRAPH_STEPS``
   steps captures its decode step once, after its prefill, and replays
   it for every step but the first (the capture's warm-up step); the
   captures' host ms and the host ms to enqueue a replayed step are
   logged.  The layer-0 attention inputs of every batch's prefill and of
   a sample of decode steps (replayed ones included) are kept.  Then a
   batch of the serve's largest shape is prefilled again, its decode
   step captured and a copy of its state decoded eagerly by
   ``decode_multi``; the two 8-step windows are held bit for bit
   (tokens, logits, positions, cache), and both are timed and profiled:
   host ms a step, device ms a step and the idle share, graphed against
   eager;
8. padded timings: as phase 6, for the flash and dense decode kernels at
   the kept inputs (yardsticks: SDPA with ``is_causal`` for prefill, SDPA
   with a length mask on the cache cut to its longest row for decode);
9. SSD scan and int8 decode kernels against their plain versions: the
   scan at mamba2-780m's shapes (H 48, P 64, N 128, chunk 128; B 1 and 8;
   S 256 and 200) in f32, against the chunked version at 2e-4 of the
   output's scale and the per-token recurrence at the reference's 5e-3,
   through the wrapper and again at each P slice (32 and 64), and its
   C.B^T scratch against c @ b^T on the lower triangle;
   the int8 decode at chatglm-6b's and a 40/8 GQA shape, f32 and bf16
   queries, mixed lengths, then again with int8 extremes and NaN and inf
   scales written past the lengths, which must change nothing;
10. models: a reduced mamba2-780m (padded prefill, then a fused decode
   window) and a reduced chatglm-6b's fused decode on an int8 cache, in
   f32 on the card against the CPU;
11. SSM padded serve: ``run_engine_backend("mamba2-780m", ...,
   reduced=False)`` at full width (48 layers, d_model 1536, 48 heads,
   d_state 128) in bf16, ``magnus``, on phase 7's 64 requests.  Counts
   are zeroed just before and read just after: every request gets its
   generation length, one readback per power-of-two window, the scan
   launches once per layer and batch, and nothing else and no plain
   version runs.  Captures and replays as in phase 7; the captures'
   reserved memory shows the private pool of a step on the f32 state.
   The layer-0 scan input of every batch is kept; the decode step is
   profiled graphed against eager, as in phase 7;
12. int8 decode window: chatglm-6b at full width in bf16, 16 rows of
   2,048-token prompts, a dense prefill (cache 2,112) quantised into an
   int8 cache, then a 64-step fused decode on the bf16 cache and on the
   int8 one: the int8 kernel launches once per layer and step with no
   plain call; the first step's logits are held, distance against
   distance, to the same step in plain torch (the port's f32
   dequantisation; the bf16 window's own as the control) and to the
   reference's formulation (bf16 dequantisation), as ``int8_window``
   sets out; the layer-0 int8 inputs of every 21st step are kept;
13. timings of the scan and the int8 kernel at the kept inputs, as phase
   8 (yardsticks: none for the scan, which no single PyTorch call
   computes; SDPA with a length mask on the dequantised bf16 cache, the
   dequantisation pass it needs, timed apart, and the bf16 dense decode
   kernel on it, for int8).  Every bound takes operations at 989
   TFLOP/s; the scan logs each kept shape's time beside its B and the
   time at the other P slice, and its mean bound at the 3xTF32 rate
   (495 / 3 TFLOP/s), where it computes, and at the f32 CUDA cores' 67
   TFLOP/s, beside it;
14. warmed serve: phase 5's serve again on a fresh engine built with
   ``warmup=True`` (every admission-wave shape run once, the decode
   step captured), set up as the launcher sets it up, so with the same
   schedule.  Counts are zeroed after the warmup and just before the
   serve, and read just after: no capture during the serve, streams,
   decode steps, windows, host syncs and launches equal to phase 5's,
   no plain call.  Then a full wave's 8-step decode window through the
   captured graph is held bit for bit (tokens, logits, positions)
   against ``decode_multi_paged`` run eagerly on a copy of the state,
   and both are timed and profiled: host ms a step, device ms a step
   and the idle share, graphed against eager, beside the host time the
   warmed serve took to enqueue a replayed step;
15. chaos serve (the lifecycle and the host swap tier): phase 5's 48
   requests and weights through ``drive_paged`` on an engine with a
   128-block pool, a 128-block pinned host tier (allocated when the
   engine is built), a deadline and a ``FaultInjector`` plan of every
   fault kind but the crash (``chaos_plan``).  Counts are zeroed just
   before and read just after.  Check 1, the contract: nothing
   unserved, every request served or shed with a known reason,
   swap-outs, resumes, a quarantine, deadline misses, evictions and
   stall ticks all seen, both tiers drained, one capture, both paged
   kernels launched once per layer and step or wave, no plain call,
   and the host syncs exactly one per decode window, one per NaN-guard
   readback (the engine counts them) and two per swap-out.  The
   layer-0 inputs of every decode step and admission wave of the serve
   (re-admissions and resumed slots' tables included) go through each
   paged kernel and its plain version on the chaos engine's pools, held
   as in phase 6.  Check 2: of two engines admitted identically, one
   has a slot poisoned; after the window it quarantines exactly that
   request, and every other slot's tokens and logits equal the other
   engine's bit for bit.  Check 3: one of two such engines suspends a
   slot and resumes it; its pages, logits row and position equal the
   other's bit for bit, nothing is re-prefilled, and the next window is
   bit-equal.  Check 4: each finished stream against phase 5's; one
   that differs must have been restarted or have another KV lineage
   than in phase 5 (a wave of another shape wrote its KV or its cached
   prefix: bf16 GEMMs of another M may round otherwise); and the
   witness, in f32 (TF32 off) on one f32 weight set: phase 5's serve
   through its launcher (its steps, waves and host syncs equal phase
   5's; its waves' lineages stand for phase 5's), then the chaos serve
   (its counters and sheds equal the bf16 one's), whose every finished
   stream must equal the f32 serve's.  Logged: tokens/s beside phase
   5's, the host-sync split, host ms and GB/s a swap-out and a resume,
   the pinned tier's size and the engine's build time, the NaN guard's
   host ms;
16. speculative decoding (§16), the draft-and-verify window captured as
   one graph per engine.  (a) Phase 5's serve through its launcher with
   ``spec_decode=True`` (a self-draft sharing the target's weights,
   draft_k ``DRAFT_K``); counts zeroed just before and read just after:
   every request served, the pool drained, one capture (the window's,
   never the plain decode step's), host syncs exactly one a spec
   window, the paged decode kernel launched W = draft_k + 1 times a
   window per draft layer, the prefix-prefill kernel once a verify, a
   target wave (target layers) and a draft wave (draft layers), no
   plain call.  Every draft step, verify (S = W) and wave of the serve,
   recorded at layer 0 (a replayed window's from the tensors the graph
   captured), is held against the plain kernels on its own pool, as
   phase 6 holds; the streams are compared with phase 5's by cause
   (``compare_streams``); the verify's prefix prefill and the draft's
   decode are timed at a sample of their own inputs as phase 6 times;
   one 32-row window is profiled graphed, and the draft's steps and the
   verify apart, eagerly.  (b) A rejecting draft (chatglm-6b cut to
   ``SMALL_DRAFT``, head size 64, seed 1) through ``PagedContinuousEngine``
   and ``drive_paged``: the same count checks, its acceptance below 1,
   the holds, both pools drained.  (c) The f32 witness (TF32 off, phase
   15's f32 weights, ``SPEC_F32_BLOCKS`` blocks a pool) in the
   batch-invariant arithmetic (``model.batch_invariant``, in which a
   token's bits do not depend on its batch, wave or window): a spec-off
   serve, then a self-draft spec serve, whose every stream must equal
   the spec-off serve's, with the self-draft's acceptance 1.0; each
   differing stream and each rejected proposal is logged before the
   verdict.  Each engine is dropped before the next is built; the
   phase's peak allocation is logged;
17. kill and recover (§17: the snapshot, the write-ahead journal and
   the restore, in place under the captured decode graph), at full
   width with phase 5's requests and weights, snapshots in a temporary
   directory whose free space is checked first and which the phase
   removes.  (a) Phase 5's geometry with the radix cache, driven as the
   launcher drives it (``magnus_service``) by ``drive_paged`` under a
   ``RecoveryManager`` and a ``FaultInjector`` with one crash at the
   window seam: snapshots after windows 2 and 4, the crash at window
   6 (rows in flight, 32 requests finished), the crashed engine and its
   pool dropped, then ``recover()`` onto an engine built with
   ``warmup=True`` (its decode graph captured before the restore) and
   sharing the weight tensors.  Right after the restore the restored
   blocks and logits rows equal the file's bytes and the tensors the
   graph captured are the engine's; the first window and every later
   one replays (no capture), and each recovered decode step and replay
   wave is held against the plain kernels at layer 0 right after its
   window (the first window's steps also timed on the restored pool, as
   phase 6 times); every request recovered, nothing re-prefilled, both
   pools drained, launches once per layer and step or wave of both
   engines, and the recovered engine's steps, waves and host syncs
   phase 5's plus exactly two syncs a snapshot.  Logged: each
   snapshot's bytes and host seconds to gather and read back, to hash
   and to write, ``restore_s``, the recovered serve's tokens/s beside
   phase 5's; the streams and journal mismatches against phase 5's, by
   cause.  (b) Phase 15's geometry (128 blocks, the pinned host tier,
   app head1 under-predicted, a 40-block pool shrink): a snapshot with
   images in the tier, the crash at a swap-out; the restored tier's
   used slots equal the file's ``swap_store`` through the layout
   conversion, the store is pinned, the resumed requests' decode is
   held, the tier drains.  (c) The f32 witness (TF32 off, inside
   ``batch_invariant()``, phase 16 (c)'s weights and pool): an uncrashed
   serve, then (a)'s crash and recovery, whose every stream must equal
   it, with no journal mismatch; a bf16 stream of (a) that differs from
   phase 5's fails only where (c) differs too.

18. MoE serve: ``run_paged_engine_backend("olmoe-1b-7b", ...,
   reduced=False)`` in bf16 (16 layers, d_model 2048, 64 experts top 8;
   weights drawn on the card from seed 0 once chatglm-6b's are gone)
   with the radix cache, on phase 5's geometry and requests.  Fatal
   checks: every request finishes, the pool drains, the cache hits;
   decode steps, waves and host syncs as ``scripts/moe_rehearsal.py``
   predicts (``MOE_SCHEDULE``), the decode kernel 16 times a step and
   prefix prefill 16 times a wave, one capture and replays after it;
   every step's and wave's layer-0 attention held as phase 6 holds; the
   layer-0 capacity-dispatch FFN of every 16th step and every wave held
   against a per-token plain form that finds the drop set itself, in
   bf16 (5e-2) and f32 with TF32 off (2e-4); a graphed decode window
   against an eager one bit for bit (tokens, logits, positions, pools).
   Logged: the dropped share of every step and wave at layer 0, the
   step's bound (its weights at 3.35 TB/s), both windows' profiles,
   tokens/s beside phase 5's, the peak allocation, and rows 1-2 timed
   at olmoe's inputs as phase 6 times them.
19. hybrid serve: ``run_engine_backend("hymba-1.5b", ...,
   reduced=False)`` in bf16 (32 layers, d_model 1600, 25 query heads
   over 5 KV heads of 64 beside 25 SSM heads of 64 with d_state 16, a
   2,048-token window; weights drawn on the card from seed 0 once
   olmoe-1b-7b's are gone), ``magnus`` through the padded
   ``BatchEngine`` on phase 7's requests.  (a) Fatal checks: every
   request gets its generation length, every batch G(B) iterations;
   batches, steps, host syncs, captures, the WMA total and the batches'
   shapes as ``scripts/hybrid_rehearsal.py`` predicts
   (``HYBRID_SCHEDULE``); flash and the scan 32 times a batch, dense
   decode 32 times a step, nothing else and no plain version; one
   capture a batch and replays after it; each batch's layer-0 flash
   call (window mode) and a sample of decode steps held as phase 6
   holds; graphed and eager windows of the largest batch held bit for
   bit (all four cache leaves: K, V, the SSD and conv states) and
   profiled beside the step's bound.  (b) A 4,096-token prefill of two
   rows (4,096 and 3,000 tokens), where the window binds in every
   layer: layer 0's flash call held at 5e-2 and its scan (32 chunks, N
   16) in f32 at 2e-4; then 8 decode steps on the engines' 8,192-slot
   cache and on the 2,048-slot ring, every step's layer-0 decode
   attention held.  (c) Flash (at the serve's shapes and windowed at S
   4,096, against SDPA with a band mask), dense decode at G 5 and the
   scan at N 16 (both P slices) timed at those inputs as phase 6
   times.  (d) tokens/s beside phases 7 and 11, the peak allocation.
20. MLA serve: deepseek-v3-671b at its published widths (d_model 7168,
   128 heads, q_lora 1536, kv_lora 512, nope 128, rope 64, v 128; 256
   experts of 2,048 top 8 plus a shared one) cut to 2 layers and no
   MTP module (``MLA_CUT``; 49.8 GB in bf16, drawn on the card from seed
   0 once hymba-1.5b's weights are gone, a slice at a time), in bf16
   through the padded launcher's loop (``serve_padded``, ``magnus``)
   on phase 7's requests.  (a) Fatal checks: every request gets its
   generation length; batches, steps, host syncs, captures, the WMA
   total and the shapes as ``scripts/mla_vlm_rehearsal.py`` predicts
   (``MLA_SCHEDULE``); no kernel launch and no plain call (MLA is plain
   PyTorch, as in the reference); one capture a batch; the layer-0
   absorbed decode of a sample of steps (replayed ones included) held
   against the naive form (K and V expanded from the latent, f32) at
   ``MLA_TOL`` of scale; graphed and eager windows of the largest batch
   bit for bit (both latent leaves, logits, positions), profiled beside
   the step's bound.  (b) A prefill of 2,048 and 1,500 tokens: layer
   0's ``mla_prefill`` in two KV chunks of 1,024 held against one chunk
   (bf16 5e-2, f32 2e-4).  (c) Logged: ``init_params``'s host seconds
   and peak, tokens/s beside phase 7's, the phase's peak allocation.
21. vlm serve: ``run_engine_backend("internvl2-26b", ...,
   reduced=False)`` uncut in bf16 (48 layers, d_model 6144, 48 query
   heads over 8 KV heads of 128, 256 zero patches before every prompt),
   ``magnus`` on phase 7's requests once deepseek-v3-671b's weights are
   gone.  Fatal checks: as phase 19's (``VLM_SCHEDULE``); flash 48
   times a batch at S = bl + 256, dense decode 48 times a step on a
   ``_bucket(bl + G(B) + 256)`` cache; every batch's layer-0 flash call
   and a sample of decode steps held as phase 6 holds; graphed and
   eager windows bit for bit.  Logged: both kernels timed at these
   inputs as phase 8 times them, the step's bound, tokens/s beside
   phase 7's, the peak allocation.
22. enc-dec serve: whisper-large-v3 uncut in bf16 (32 encoder and 32
   decoder layers, d_model 1280, 20 heads of 64, 1,500 zero frames
   padded to 1,536) once internvl2-26b's weights are gone.  (a) The
   flash kernel's full mode with Sq != Sk and a key bound at whisper's
   heads (the encoder's S 1,536 with 1,500 keys, the cross prefill's Sq
   64 and 256, bounds off the tile) and (b) the dense decode kernel on
   a 1,536-row cross cache at length 1,500, each against its plain
   version in f32 (TF32 off, 2e-4) and bf16 (5e-2), with NaN past the
   bound changing no output bit.  (c) A reduced whisper in f32 on the
   card against the CPU: logits at 2e-4, greedy tokens equal.  (d)
   ``run_engine_backend("whisper-large-v3", ..., reduced=False)``,
   ``magnus`` on phase 7's requests: as phase 21's checks
   (``ENCDEC_SCHEDULE``, from ``scripts/encdec_rehearsal.py``); flash 96
   times a batch (the encoder, the decoder's causal self-attention and
   its cross attention), dense decode 64 times a step (self and cross);
   each batch's three layer-0 flash calls and a sample of steps' two
   layer-0 decode calls held; graphed and eager windows bit for bit.
   Logged: each batch's encoder card ms, both kernels timed at these
   inputs, the step's bound, tokens/s beside phase 7's, the peak.

23. training (``train_phase``): (a) the flash forward (out and its
   log-sum-exp) and the backward kernel (``csrc/flash_attention_bwd.cu``)
   against their plain versions at smollm-135m's call and in every mode
   (a window, a key bound with NaN past it, G 1 and 3, D 32/64/128,
   whisper-large-v3's encoder, cross and decoder calls), f32 at 2e-4
   (TF32 off) and bf16 at 5e-2, two launches bit-equal; the autograd
   wrapper in both dtypes.  (b) One
   train step of smollm-135m at full width cut to 2 layers on the card
   against the CPU on the same weights and batch: loss and lr at 2e-4
   of scale, card against CPU f32; the grad norm, and every gradient
   leaf, no farther from the CPU's f64 run than the CPU's own f32 run
   is (a leaf also passes within 2e-4 of its own scale).  (c) ``repro_torch.launch.train`` on smollm-135m uncut (B 8, S
   256, f32, TF32 off) for 10 steps: the flash forward 60 launches a
   step (remat recomputes each layer), the backward 30, finite losses,
   the first batch's loss lower after training.  Logged: tokens/s, step
   ms, peak memory.  (d) Both kernels timed at that call in f32 and
   bf16 beside their plain versions and SDPA's forward or backward, and
   the f32 step's breakdown (flash forward, backward, GEMMs, the AdamW
   update).  (e) bf16 training: the 2-layer step of (b) in bf16
   (``make_train_step``'s default) on the card against the CPU's bf16
   step, each gradient leaf, the loss and the grad norm within twice
   the CPU's bf16 distance from its f32 step; then ``trainer.train``
   on smollm-135m uncut with bf16 activations for 10 steps, held as
   (c), and the bf16 step's breakdown.
24. training the SSM and hybrid families (``ssm_train_phase``): (a) the
   scan forward's stored chunk states and C.B^T scratch and the scan's
   backward kernel (``csrc/ssd_scan_bwd.cu``, which reads both) against
   their plain versions at
   mamba2-780m's and hymba-1.5b's training calls (B 8, S 256), a ragged
   S at both widths, chunks of 64 and ragged P and N, with the final
   state's gradient dropped and given: each output at 2e-4 of its
   scale, or no farther from the plain f64 run than the plain f32 one;
   two launches bit-equal; the autograd wrapper launches the forward and
   the backward once.  (b) As phase 23 (b), one step of each at full
   width cut to 2 layers, card against CPU, but the grad norm and each
   leaf (unless within 2e-4 of its own scale) held no farther from the
   CPU's f64 run than twice the card's own f32 step through the plain
   versions: the card's other f32 arithmetic alone lands hymba's grad
   norm 2.0x the CPU's f32 distance (``scripts/ssm_train_hold.py``
   grounds the factor at two seeds and shows planted wiring faults of
   the scan's gradient failing it).  (c) ``repro_torch.launch.train`` on
   mamba2-780m (48 layers) and hymba-1.5b (32) uncut, 10 steps each at
   the launcher's defaults, held as phase 23 (c) (mamba2: the scan's
   forward 960 launches, its backward 480; hymba: 640 and 320, flash's
   640 and 320), and each f32 step's breakdown.  (d) ``trainer.train``
   on hymba-1.5b uncut with bf16 activations (the scan in f32), held
   the same way.  (e) The scan's forward (with its state store) and
   backward timed at both training calls beside their plain versions
   and bounds, each split by its CUDA kernels' device times.
25. sanitized serves under PyTorch's sync detector (``sync_phase``):
   the port's hot-path lint (``repro_torch/analysis/hotlint.py``) swept
   over ``src/repro_torch`` must report nothing; then, with
   ``REPRO_SANITIZE=1`` and ``torch.cuda.set_sync_debug_mode("warn")``
   (a ``warnings.showwarning`` hook records each reported call's
   innermost ``repro_torch`` frame), one path to each of the six counted
   sync sites, every engine warmed (its graph captured) first: (a)
   phase 15's chaos plan on chatglm-6b uncut in bf16 (``step_window``,
   its NaN guard, ``_swap_out``); (b) a speculative serve
   (``_spec_window``), (c) one ``snapshot``, (d) one padded
   ``BatchEngine`` batch after a warm one (``serve_batch``), (e)
   ``ContinuousEngine.step``s, at chatglm-6b's widths cut to 2 layers.
   Fatal checks: the ledger's sites equal the lint's
   ``collect_sync_sites``, ``check_sync_ledger`` passes on them, the
   ledger sums to the engines' ``host_syncs`` (and each path's to its
   own), every reported synchronising call sits at a site the lint
   suppresses (counted or ``uncounted:``), and no window of (a) reports
   more syncs than the ledger counts in it.  Logged: each path's ledger
   and detector counts by site and line, each window's pair, the
   phase's seconds.

26. context-parallel decode (``cp_phase``; ``scripts/cp_phase.py`` runs
   it alone): qwen2.5-14b uncut with its 40 query heads padded to 48 and
   ``decode_cp`` (the reference's hillclimb ``cp_flash_decode``), at
   decode_32k's 32,768-slot cache.  (b) One layer's
   ``gqa_decode_attention_cp`` on two ranks, processes on the one card
   over a gloo group (NCCL refuses two ranks on one card) on a (data 1,
   model 2) mesh, the cache split 2 x 16,384, each rank's half through
   the decode kernel's partial mode: against the one-device decode
   kernel on the whole cache, f32 within 1e-5 and bf16 within 1e-2 of
   scale; each rank's partial kernel against its plain version.  (a)
   One device, no mesh, bf16, 4 rows: ``decode_cp`` decodes 3 steps
   from a seeded cache bit-equal to the flag off (logits and written
   slots), the dense decode kernel 48 times a step; 4 of phase 7's
   requests through ``BatchEngine``, streams equal on and off.  (c) The
   two ranks run 3 whole f32 ``decode_step``s under the mesh's rules
   (1 row: the f32 weights, 61.1 GB, are shared by CUDA IPC, and the
   row's 12.9 GB cache is split between the ranks), each rank's logits
   within 2e-4 of scale of the same steps on one device; the partial
   kernel 48 times a step on each rank, no dense decode; the
   sanitizer's ledger counts the merge's 3 host-staged all-reduces a
   layer and step at ``gqa_decode_attention_cp``.  Logged beside the
   card's name and power limit: the partial kernel's ms, bound,
   plain-version and SDPA ms at (c)'s shard and (b)'s bf16 shard, the
   merge's ms a layer, the step ms on a rank against one device, greedy
   agreement.

27. the dry run and the roofline (``roofline_phase``;
   ``scripts/roofline_phase.py`` runs it alone).  (a)
   ``repro_torch.launch.dryrun --all`` (10 archs x 4 shapes x 2 meshes,
   on meta tensors over a fake 512-rank group) and
   ``repro_torch.launch.hillclimb``, side by side in subprocesses with a
   time limit, beside (b)'s mamba2 and chatglm steps: every record
   listed with its predicted peak against the card's memory and its
   dominant term; fails on an error record, a missing record or a CUDA
   context in either.  (b) smollm-135m's and
   mamba2-780m's f32 training steps (B 8, S 256) and chatglm-6b's bf16
   padded decode step (20 rows, every cache at its 512 slots), each
   dry-run at its shapes, then run under ``FlopCounterMode`` (FLOPs equal
   to the dry run's), profiled (busy at least 0.95 x the larger of
   t_compute and the memory floor; busy against the upper byte count
   logged) and its peak (``max_memory_allocated`` less what was allocated
   beside its arguments) within 10% of the predicted one; smollm's
   eager step host ms and chatglm's bytes beside ``padded_step_bound``'s
   logged.

Phases 9 and 10 run right after phase 4, so that a fault in a kernel or
a model stops the run before the serves; phase 14 runs right after
phase 5, then phases 15 to 25, 27 (before 26: the weights phase 26
shares with its ranks by CUDA IPC stay allocated in this process after
they exit) and 26 last.  The line before the
last is a JSON object with one entry per kernel (nine: the six TPU
kernels' counterparts, the flash backward, the scan's backward and the
decode kernel's context-parallel partial); the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero, with no
result line, when CUDA is missing or the port's sources are not beside
this script.
"""
from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12              # H100 SXM f32 peak outside the tensor cores
TF32_FLOPS = 495e12            # H100 SXM dense tf32 tensor-core peak

# serve-phase geometry (bf16 pool of 2048 blocks x 16 tokens x 458,752 B)
SERVE = dict(num_blocks=2048, block_tokens=16, max_concurrency=32,
             max_len=512, max_gen=128)
N_REQUESTS = 48
GEN_LENGTH = 64
SPIN_CYCLES = 20_000_000       # ~10 ms spin queued ahead of each timed call
DECODE_REPS = 5                # timed calls per served decode step
PREFILL_REPS = 11              # timed calls per served admission wave

# padded-serve traffic: the first 64 of a Poisson stream (8 req/s over
# 60 s, prompts of 32-256 tokens, generation targets up to 64)
DENSE_N_REQUESTS = 64
DENSE_MAX_LEN, DENSE_MAX_GEN = 256, 64
DECODE_SAMPLE = 21             # keep every 21st decode step of a batch
KEEP_BYTES = 4 << 30           # cap on the kept layer-0 inputs

# int8 decode window: chatglm-6b, 16 rows of 2,048-token prompts
INT8_ROWS, INT8_PROMPT, INT8_STEPS = 16, 2048, 64
SCAN_TOL = 2e-4                # f32 scan vs its chunked plain version,
#                                of the output's scale

# phase 16, speculative decoding: draft_k, the rejecting draft's cut of
# chatglm-6b (the same vocab, head size 64), and the f32 witness's pool
# (two f32 pools of 1,024 blocks, 15.0 GB each, beside 28 GB of f32
# weights)
DRAFT_K = 4
SMALL_DRAFT = dict(num_layers=4, d_model=1024)
SPEC_F32_BLOCKS = 1024
SPEC_TIMED = 24                # kept verifies / draft steps timed, evenly


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def paged_inputs(torch, *, b, hq, hkv, d, bt, nb, mb, lengths, dtype, gen):
    """Random q and pools; row i's table holds distinct random pages
    (block 0 stays out of every table)."""
    q = torch.randn(b, hq, d, generator=gen, device="cuda").to(dtype)
    kp = torch.randn(nb, bt, hkv, d, generator=gen, device="cuda").to(dtype)
    vp = torch.randn(nb, bt, hkv, d, generator=gen, device="cuda").to(dtype)
    perm = torch.randperm(nb - 1, generator=gen, device="cuda") + 1
    tables = perm[:b * mb].reshape(b, mb).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, kp, vp, tables, lens


def prefill_inputs(torch, *, b, s, hq, hkv, d, bt, nb, mb, plens, slens,
                   dtype, gen):
    q = torch.randn(b, s, hq, d, generator=gen, device="cuda").to(dtype)
    ks = torch.randn(b, s, hkv, d, generator=gen, device="cuda").to(dtype)
    vs = torch.randn(b, s, hkv, d, generator=gen, device="cuda").to(dtype)
    kp = torch.randn(nb, bt, hkv, d, generator=gen, device="cuda").to(dtype)
    vp = torch.randn(nb, bt, hkv, d, generator=gen, device="cuda").to(dtype)
    perm = torch.randperm(nb - 1, generator=gen, device="cuda") + 1
    tables = perm[:b * mb].reshape(b, mb).to(torch.int32)
    pl = torch.tensor(plens, dtype=torch.int32, device="cuda")
    sl = torch.tensor(slens, dtype=torch.int32, device="cuda")
    return q, ks, vs, kp, vp, tables, pl, sl


def cycle(vals, n):
    return [vals[i % len(vals)] for i in range(n)]


# ---------------------------------------------------------------------------
# phase 2: what the compiler made of the kernels
# ---------------------------------------------------------------------------

def _demangle(build, names):
    """Readable kernel names, by the toolkit's cu++filt where there is one."""
    filt = os.path.join(os.path.dirname(build.nvcc_path()), "cu++filt")
    if not names or not os.path.isfile(filt):
        return {n: n for n in names}
    res = subprocess.run([filt], input="\n".join(names), capture_output=True,
                         text=True, timeout=60)
    out = res.stdout.splitlines()
    return dict(zip(names, out)) if len(out) == len(names) else \
        {n: n for n in names}


def build_report(build, lib):
    """Each kernel's registers, static shared memory and spills from the
    build's ``-Xptxas -v`` log, and its tensor-core instructions (HGMMA,
    HMMA) in the library's SASS where the toolkit has ``cuobjdump``.
    Fails if the bf16 flash or bf16 prefix-prefill kernel, or an
    instance of the f32 flash forward (``flash_mma_kernel``), of the
    flash backward (``flash_bwd_kernel``, f32 and bf16), of either SSD scan
    kernel (``ssd_cb_kernel``, ``ssd_scan_kernel``) or of the scan's
    backward (``ssd_bwd_chain_kernel``, ``ssd_bwd_chunk_kernel``,
    ``ssd_bwd_bc_kernel``; the f32 ones 3xTF32 on mma.sync), has no
    tensor-core instruction, or if a scan backward kernel spills."""
    import re
    kern = {}
    name = None
    for line in lib.with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            kern[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            kern[name]["spill"] = f"{m.group(1)}/{m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m:
            kern[name]["regs"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            kern[name]["smem"] = f"{sm.group(1) if sm else 0} B static"
    tc = {}
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    if os.path.isfile(cuobjdump):
        sass = subprocess.run([cuobjdump, "-sass", str(lib)],
                              capture_output=True, text=True,
                              timeout=300).stdout
        fn = None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1)
                tc[fn] = [0, 0]
            elif fn is not None:
                op = re.search(r"\b(HGMMA|HMMA)\.", line)
                if op:
                    tc[fn][op.group(1) == "HMMA"] += 1
    else:
        log("  cuobjdump is not in the toolkit: tensor-core instructions "
            "not counted")
    names = _demangle(build, sorted(kern))
    for mangled in sorted(kern, key=lambda n: names[n]):
        k = kern[mangled]
        hg, hm = tc.get(mangled, ["-", "-"]) if tc else ["-", "-"]
        log(f"  {names[mangled][:110]}: {k.get('regs', '?')} registers, "
            f"{k.get('smem', '?')} smem, spills {k.get('spill', '?')}, "
            f"HGMMA {hg}, HMMA {hm}")
    bwd = [n for n in kern if "ssd_bwd_" in n]
    check(len(bwd) == 9 and all(kern[n].get("spill") == "0/0 B"
                                for n in bwd),
          "the scan's backward kernels spill, or are not the nine "
          "instances: " + json.dumps({names[n][:60]: kern[n].get("spill")
                                      for n in bwd}))
    if tc:
        for kind in ("flash_tc_kernel", "flash_mma_kernel",
                     "flash_bwd_kernel", "prefix_prefill_tc_kernel",
                     "ssd_cb_kernel", "ssd_scan_kernel",
                     "ssd_bwd_chain_kernel", "ssd_bwd_chunk_kernel",
                     "ssd_bwd_bc_kernel"):
            fns = [n for n in tc if kind in n]
            check(fns and all(tc[n][0] + tc[n][1] > 0 for n in fns),
                  f"a {kind} has no tensor-core instruction: "
                  f"{ {n: tc[n] for n in fns} }")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_checks(torch, ops, ref):
    """Each kernel against its plain version on random unit-size inputs
    at chatglm-6b's, GQA and edge shapes, f32 and bf16, then the poison
    cases."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    tol = {torch.float32: 2e-4, torch.bfloat16: 5e-2}
    decode_shapes = [   # (name, b, hq, hkv, d, bt, nb, mb, lengths)
        ("chatglm-6b", 32, 32, 32, 128, 16, 2048, 40,
         cycle([1, 15, 16, 17, 56, 100, 127, 250, 640], 32)),
        ("gqa smollm-135m", 8, 9, 3, 64, 16, 256, 16,
         [1, 16, 33, 64, 200, 256, 77, 5]),
        ("b2 splits g2 d64 bt8", 2, 8, 4, 64, 8, 256, 120, [641, 900]),
        ("b1 splits g12 d32 bt32", 1, 24, 2, 32, 32, 64, 40, [1000]),
        ("page edges g3 d32 bt32", 6, 6, 2, 32, 32, 64, 4,
         [15, 16, 17, 31, 32, 33])]
    prefill_shapes = [  # (name, b, s, hq, hkv, d, bt, nb, mb, plens, slens)
        ("chatglm-6b mixed", 32, 64, 32, 32, 128, 16, 2048, 40,
         cycle([0, 32, 48, 47, 0, 600], 32), cycle([56, 24, 8, 9, 64, 1], 32)),
        ("chatglm-6b misses", 32, 64, 32, 32, 128, 16, 2048, 1,
         [0] * 32, cycle([56, 13, 64, 1], 32)),
        ("gqa smollm-135m", 4, 24, 9, 3, 64, 16, 128, 8,
         [0, 17, 64, 128], [24, 5, 1, 20]),
        ("g3 two row tiles d64", 3, 40, 6, 2, 64, 16, 64, 9,
         [70, 0, 130], [40, 17, 33]),
        ("s 100 d32 bt8", 3, 100, 2, 2, 32, 8, 64, 8,
         [9, 64, 0], [100, 65, 7])]
    for dtype in (torch.float32, torch.bfloat16):
        torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
        torch.backends.cudnn.allow_tf32 = False         # in the plain path
        for name, b, hq, hkv, d, bt, nb, mb, lengths in decode_shapes:
            args = paged_inputs(torch, b=b, hq=hq, hkv=hkv, d=d, bt=bt,
                                nb=nb, mb=mb, lengths=lengths, dtype=dtype,
                                gen=gen)
            out = ops.paged_decode_attention(*args)
            want = ref.paged_decode_attention_ref(*args)
            torch.cuda.synchronize()
            err = (out.float() - want.float()).abs().max().item()
            check(torch.isfinite(out).all().item(), f"decode {name}: NaN")
            log(f"kernel paged_decode_attention {name} {dtype}: "
                f"max_abs_err {err:.3e} (tol {tol[dtype]})")
            check(err <= tol[dtype], f"decode {name} {dtype}: err {err}")
        for name, b, s, hq, hkv, d, bt, nb, mb, plens, slens \
                in prefill_shapes:
            args = prefill_inputs(torch, b=b, s=s, hq=hq, hkv=hkv, d=d,
                                  bt=bt, nb=nb, mb=mb, plens=plens,
                                  slens=slens, dtype=dtype, gen=gen)
            out = ops.paged_prefix_prefill_attention(*args)
            want = ref.paged_prefix_prefill_attention_ref(*args)
            torch.cuda.synchronize()
            err = (out.float() - want.float()).abs().max().item()
            check(torch.isfinite(out).all().item(), f"prefill {name}: NaN")
            log(f"kernel paged_prefix_prefill_attention {name} {dtype}: "
                f"max_abs_err {err:.3e} (tol {tol[dtype]})")
            check(err <= tol[dtype], f"prefill {name} {dtype}: err {err}")
    poison_checks(torch, ops, gen)


def poison_checks(torch, ops, gen):
    """Poisoning pages outside a row's table (its pad entries' included),
    its own slots past its length, and (prefill) suffix keys past
    suffix_len must not change the row's output at all, in f32 and
    bf16."""
    f = dict(device="cuda", generator=gen)
    for dtype in (torch.float32, torch.bfloat16):
        rnd = lambda *shape: torch.randn(*shape, **f).to(dtype)
        # decode: bt 16, Hq 4, Hkv 2, D 32, lengths (23, 40)
        q, kp, vp = rnd(2, 4, 32), rnd(6, 16, 2, 32), rnd(6, 16, 2, 32)
        tables = torch.tensor([[1, 2, 0], [3, 4, 5]], dtype=torch.int32,
                              device="cuda")
        lens = torch.tensor([23, 40], dtype=torch.int32, device="cuda")
        out1 = ops.paged_decode_attention(q, kp, vp, tables, lens)
        kp2, vp2 = kp.clone(), vp.clone()
        for t in (kp2, vp2):
            t[0] = float("nan")            # the pad entry of row 0's table
            t[2, 7:] = float("nan")        # row 0's own slots past 23
            t[3:] = -1e4                   # row 1's pages
        out2 = ops.paged_decode_attention(q, kp2, vp2, tables, lens)
        err = (out1[0] - out2[0]).abs().max().item()
        log(f"kernel paged_decode_attention poison {dtype}: "
            f"max_abs_change {err:.3e}")
        check(err == 0.0, f"decode poison changed the output by {err}")
        # prefill: bt 8, Hq 4, Hkv 2, D 32, S 8, plens (12, 20), slens (8, 5)
        q, ks, vs = rnd(2, 8, 4, 32), rnd(2, 8, 2, 32), rnd(2, 8, 2, 32)
        kp, vp = rnd(7, 8, 2, 32), rnd(7, 8, 2, 32)
        tables = torch.tensor([[1, 2, 0], [3, 4, 5]], dtype=torch.int32,
                              device="cuda")
        pl = torch.tensor([12, 20], dtype=torch.int32, device="cuda")
        sl = torch.tensor([8, 5], dtype=torch.int32, device="cuda")
        out1 = ops.paged_prefix_prefill_attention(q, ks, vs, kp, vp, tables,
                                                  pl, sl)
        kp2, vp2, ks2, vs2 = kp.clone(), vp.clone(), ks.clone(), vs.clone()
        for t in (kp2, vp2):
            t[0] = float("nan")            # the pad entry of row 0's table
            t[2, 4:] = float("nan")        # row 0's own slots past plen 12
            t[3] = 1e4                     # row 1's page
        for t in (ks2, vs2):
            t[1, 5:] = float("nan")        # row 1's suffix keys past slen 5
        out2 = ops.paged_prefix_prefill_attention(q, ks, vs, kp2, vp2,
                                                  tables, pl, sl)
        out3 = ops.paged_prefix_prefill_attention(q, ks2, vs2, kp, vp,
                                                  tables, pl, sl)
        err = max((out1[0] - out2[0]).abs().max().item(),
                  (out1[1] - out3[1]).abs().max().item())
        log(f"kernel paged_prefix_prefill_attention poison {dtype}: "
            f"max_abs_change {err:.3e}")
        check(err == 0.0, f"prefill poison changed the output by {err}")


def dense_kernel_checks(torch, fops, fref, dops, dref):
    """The flash prefill and dense decode kernels against their plain
    versions on random unit-size inputs at chatglm-6b's heads (32/32, D
    128) and a GQA shape (40/8, D 128), f32 and bf16; decode then again
    with NaN written past every row's length, which must change
    nothing."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    tol = {torch.float32: 2e-4, torch.bfloat16: 5e-2}
    modes = {"causal": dict(causal=True, window=None),
             "window": dict(causal=True, window=64),
             "full": dict(causal=False, window=None)}
    flash_shapes = [("chatglm-6b", 4, 256, 32, 32, 128),   # b, s, hq, hkv, d
                    ("gqa 40/8", 4, 200, 40, 8, 128)]
    decode_shapes = [("chatglm-6b", 16, 512, 32, 32, 128,  # b, s, hq, hkv, d
                      cycle([1, 17, 31, 32, 33, 200, 511, 512], 16)),
                     ("gqa 40/8", 8, 512, 40, 8, 128,
                      [512, 13, 256, 1, 77, 300, 500, 64])]
    rnd = lambda *shape, dt: torch.randn(*shape, generator=gen,
                                         device="cuda").to(dt)
    for dtype in (torch.float32, torch.bfloat16):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        for name, b, s, hq, hkv, d in flash_shapes:
            q, k, v = (rnd(b, s, h, d, dt=dtype) for h in (hq, hkv, hkv))
            for mode, kw in modes.items():
                out = fops.flash_attention(q, k, v, **kw)
                want = fref.flash_attention_ref(q, k, v, **kw)
                torch.cuda.synchronize()
                err = (out.float() - want.float()).abs().max().item()
                check(torch.isfinite(out).all().item(),
                      f"flash {name} {mode}: NaN")
                log(f"kernel flash_attention {name} S={s} {mode} {dtype}: "
                    f"max_abs_err {err:.3e} (tol {tol[dtype]})")
                check(err <= tol[dtype], f"flash {name} {mode} {dtype}: "
                      f"err {err}")
        for name, b, s, hq, hkv, d, lengths in decode_shapes:
            q = rnd(b, hq, d, dt=dtype)
            kc, vc = rnd(b, s, hkv, d, dt=dtype), rnd(b, s, hkv, d, dt=dtype)
            lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            out = dops.decode_attention(q, kc, vc, lens)
            want = dref.decode_attention_ref(q, kc, vc, lens)
            for i, n in enumerate(lengths):
                kc[i, n:], vc[i, n:] = float("nan"), float("nan")
            poisoned = dops.decode_attention(q, kc, vc, lens)
            torch.cuda.synchronize()
            err = (out.float() - want.float()).abs().max().item()
            change = (poisoned.float() - out.float()).abs().max().item()
            log(f"kernel decode_attention {name} S={s} {dtype}: max_abs_err "
                f"{err:.3e} (tol {tol[dtype]}); NaN past the lengths "
                f"changes it by {change:.3e}")
            check(err <= tol[dtype], f"decode {name} {dtype}: err {err}")
            check(change == 0.0, f"decode {name}: NaN past the lengths "
                  f"changed the output by {change}")


# ---------------------------------------------------------------------------
# phase 4: the paged model on the card against the plain path on the CPU
# ---------------------------------------------------------------------------

def model_check(torch, np):
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.params import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("chatglm-6b").reduced()
    params_cpu = init_params(cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu")
    params_gpu = _to(torch, params_cpu, "cuda")
    rng = np.random.default_rng(0)
    nb, bt, null = 64, 8, 63
    b, s, mb, steps = 4, 16, 8, 4
    tables = rng.permutation(np.arange(1, null))[:b * mb].reshape(b, mb)
    # rows 0-1 miss; rows 2-3 hit a cached prefix (random pages), and
    # row 3's partial tail block is a copy-on-write clone
    plens = np.array([0, 0, 16, 12])
    lens = np.array([16, 9, 7, 11])
    tokens = rng.integers(3, cfg.vocab_size, size=(b, s))
    dec_tokens = rng.integers(3, cfg.vocab_size, size=(steps, b))
    pool = torch.randn((2, cfg.num_layers, nb, bt, cfg.num_kv_heads,
                        cfg.head_dim), generator=torch.Generator()
                       .manual_seed(1))
    results = {}
    for dev, params in (("cpu", params_cpu), ("cuda", params_gpu)):
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int32,
                                      device=dev)
        pages = {"k": pool[0].to(dev, copy=True),
                 "v": pool[1].to(dev, copy=True)}
        state = {"tables": t(np.full((b, mb), null)),
                 "positions": t(np.zeros(b)),
                 "active": torch.zeros(b, dtype=torch.bool, device=dev),
                 "logits": torch.zeros(b, cfg.padded_vocab, device=dev)}
        batch = {"tokens": t(tokens), "lengths": t(lens),
                 "prefix_lens": t(plens), "attn_tables": t(tables),
                 "tables": t(tables), "write_lens": t(lens),
                 "cow_src": t([null, null, null, tables[0, 0]]),
                 "cow_dst": t([null, null, null, tables[3, 1]]),
                 "slots": t(np.arange(b)), "row_sel": t(np.arange(b)),
                 "positions": t(plens + lens)}
        pages, state = M.prefill_wave(params, cfg, pages, state, batch,
                                      null_block=null,
                                      act_dtype=torch.float32)
        out = [state["logits"].clone()]
        pos = state["positions"].clone()
        for i in range(steps):
            lg, pages = M.decode_step_paged(
                params, cfg, pages, {"tokens": t(dec_tokens[i]),
                                     "positions": pos,
                                     "block_tables": state["tables"]},
                act_dtype=torch.float32)
            out.append(lg)
            pos = pos + 1
        results[dev] = [x.cpu() for x in out] + [
            pages["k"][:, :null].cpu(), pages["v"][:, :null].cpu()]
    errs = [((a - c).abs().max() / (1 + c.abs().max())).item()
            for a, c in zip(results["cuda"], results["cpu"])]
    log(f"model chatglm-6b reduced f32 card vs cpu: max rel err "
        f"{max(errs):.3e} (tol 2e-4) over wave logits, {steps} decode "
        f"steps and pages")
    check(max(errs) <= 2e-4, f"model card vs cpu: {errs}")


def dense_model_check(torch, np):
    """The dense model of the padded path, reduced chatglm-6b in f32:
    prefill of right-padded prompts, then a fused decode window, on the
    card against the CPU (logits, emitted tokens and caches)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.params import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("chatglm-6b").reduced()
    params_cpu = init_params(cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu")
    rng = np.random.default_rng(2)
    b, s, steps = 3, 32, 6
    tokens = rng.integers(3, cfg.vocab_size, size=(b, s))
    lengths = np.array([32, 17, 5])
    results = {}
    for dev in ("cpu", "cuda"):
        params = params_cpu if dev == "cpu" else _to(torch, params_cpu, dev)
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int32,
                                      device=dev)
        logits, cache = M.prefill(params, cfg, {"tokens": t(tokens),
                                                "lengths": t(lengths)},
                                  act_dtype=torch.float32, cache_len=64)
        out = [logits.clone()]
        logits, cache, _, toks = M.decode_multi(
            params, cfg, cache, {"logits": logits, "positions": t(lengths)},
            num_steps=steps, act_dtype=torch.float32)
        results[dev] = (out + [logits, *cache["kv"]], toks.cpu())
    errs = [((a.cpu() - c).abs().max() / (1 + c.abs().max())).item()
            for a, c in zip(results["cuda"][0], results["cpu"][0])]
    log(f"model chatglm-6b reduced f32 dense card vs cpu: max rel err "
        f"{max(errs):.3e} (tol 2e-4) over prefill logits, the logits after "
        f"{steps} fused decode steps and the caches; tokens equal: "
        f"{torch.equal(results['cuda'][1], results['cpu'][1])}")
    check(torch.equal(results["cuda"][1], results["cpu"][1]),
          "dense decode tokens differ between card and cpu")
    check(max(errs) <= 2e-4, f"dense model card vs cpu: {errs}")


def _to(torch, tree, dev):
    if isinstance(tree, dict):
        return {k: _to(torch, v, dev) for k, v in tree.items()}
    return tree.to(dev)


# ---------------------------------------------------------------------------
# phase 5: what the serve gave the kernels
# ---------------------------------------------------------------------------

def _capturing():
    import torch
    return torch.cuda.is_current_stream_capturing()


class Recorder:
    """Inside the ``with`` block, ``module.<name>`` is wrapped: every call
    passes straight through to it (its ``ops`` wrapper counts its launch
    as always), and the calls are taken as steps of ``layers``
    consecutive calls, one per layer.  On every ``every``-th step the
    layer-0 call's inputs go through ``keep``, and what it returns is
    kept (None keeps nothing); ``keep`` copies every tensor of a step
    that may be replayed.  ``steps`` counts the steps; ``restart()``
    makes the next step the first of a new sample, as at a new batch.

    Calls made while a CUDA graph is being captured are no steps (the
    capture runs nothing): the layer-0 call's input tensors are held
    instead, and :meth:`replayed` takes them as the inputs of a step
    after each replay of the graph (see :class:`replays`).  The inputs at
    the positions ``snap`` are temporaries of the step, whose memory a
    later layer of the same replay may reuse: they are copied inside the
    capture, so each replay leaves that step's layer-0 values in the
    copies; the others (the cache, the tables) are the engine's own.

    ``at`` takes the step's call at that index instead of its first (a
    model that calls ``name`` more than once a layer, or in more than
    one stack, as the encoder-decoder family does)."""

    def __init__(self, module, name, layers, keep=lambda *a: a, every=1,
                 snap=(), at=0):
        self.module, self.name, self.layers = module, name, layers
        self.keep, self.every, self.snap, self.at = keep, every, snap, at
        self.kept, self.steps = [], 0
        self._calls = self._step = self._captured_calls = 0
        self.captured = None

    def restart(self):
        self._step = 0

    def _take(self, args, kw):
        if self._step % self.every == 0:
            item = self.keep(*args, **kw)
            if item is not None:
                self.kept.append(item)
        self._step += 1
        self.steps += 1

    def replayed(self):
        """One replay of the captured graph ran: a step, whose layer-0
        inputs are the captured tensors' contents now."""
        if self.captured is not None:
            self._take(*self.captured)

    def __enter__(self):
        self.orig = orig = getattr(self.module, self.name)

        def call(*args, **kw):
            if _capturing():
                if self._captured_calls % self.layers == self.at:
                    self.captured = (tuple(
                        a.clone() if i in self.snap else a
                        for i, a in enumerate(args)), kw)
                self._captured_calls += 1
            else:
                if self._calls % self.layers == self.at:
                    self._take(args, kw)
                self._calls += 1
            return orig(*args, **kw)

        setattr(self.module, self.name, call)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


class replays:
    """Inside the ``with`` block every replay of an engine's captured
    decode step (``DecodeGraph.replay``, paged or padded) is followed by
    each recorder's :meth:`Recorder.replayed`, and every paged decode
    window that ran steps is counted in ``windows``.  ``replayed_steps``
    and ``enqueue_s`` sum the steps that ``DecodeGraph.window`` replayed
    and the host time it took to enqueue them (it does not wait for the
    card).  ``captures`` holds, for each capture, its host seconds
    (``DecodeGraph.capture_s``) and the bytes the allocator reserved
    anew while the graph was made (its private pool, and the warm-up
    step's first blocks on a new capture stream)."""

    def __init__(self, *recorders):
        self.recorders, self.windows = recorders, 0
        self.replayed_steps, self.enqueue_s = 0, 0.0
        self.captures = []

    def __enter__(self):
        import torch
        from repro_torch.serving.engine import PagedContinuousEngine
        from repro_torch.serving.graphs import DecodeGraph
        self.targets = ((DecodeGraph, "replay", DecodeGraph.replay),
                        (DecodeGraph, "window", DecodeGraph.window),
                        (DecodeGraph, "__init__", DecodeGraph.__init__),
                        (PagedContinuousEngine, "step_window",
                         PagedContinuousEngine.step_window))
        replay, window, init, step_window = (t[2] for t in self.targets)

        def measured_init(graph, *a, **kw):
            r0 = torch.cuda.memory_reserved()
            init(graph, *a, **kw)
            self.captures.append((graph.capture_s,
                                  torch.cuda.memory_reserved() - r0))

        def replay_and_record(graph):
            replay(graph)
            for r in self.recorders:
                r.replayed()

        def timed_window(graph, k, start=0):
            t0 = time.perf_counter()
            out = window(graph, k, start)
            self.enqueue_s += time.perf_counter() - t0
            self.replayed_steps += k - start
            return out

        def counted_window(engine, *a, **kw):
            out = step_window(engine, *a, **kw)
            self.windows += out[2] > 0
            return out

        DecodeGraph.replay = replay_and_record
        DecodeGraph.window = timed_window
        DecodeGraph.__init__ = measured_init
        PagedContinuousEngine.step_window = counted_window
        return self

    def log(self, label, steps):
        """Log the captures' host ms and reserved MiB and the host ms to
        enqueue a replayed step; returns the mean capture ms."""
        ms = [c * 1e3 for c, _ in self.captures]
        log(f"{label}: {len(ms)} capture(s), host ms each "
            f"{[round(m, 2) for m in ms]}, MiB reserved anew each "
            f"{[round(b / 2 ** 20, 1) for _, b in self.captures]}; "
            f"{self.replayed_steps} of {steps} steps replayed, the host "
            f"enqueued a replayed step (replay and token copy) in "
            f"{self.enqueue_s * 1e3 / max(1, self.replayed_steps):.4f} ms "
            f"on average")
        return sum(ms) / max(1, len(ms))

    def __exit__(self, *exc):
        for cls, name, orig in self.targets:
            setattr(cls, name, orig)


def paged_recorders(transformer, layers):
    """Recorders of the paged serve's layer-0 attention inputs: every
    decode step (q, tables, lengths) and every admission wave (suffix
    q/K/V, tables, prefix and suffix lengths)."""
    decode = Recorder(transformer, "paged_decode_attention", layers,
                      lambda q, kp, vp, tables, lengths, **_:
                      (q.clone(), tables.clone(), lengths.clone()),
                      snap=(0, 4))
    prefill = Recorder(transformer, "paged_prefix_prefill_attention", layers,
                       lambda q, ks, vs, kp, vp, tables, plens, slens:
                       (q, ks, vs, tables.clone(), plens.clone(),
                        slens.clone()))
    return decode, prefill


def _device_us(prof):
    """Device time of every kernel, copy and fill in a profile (us)."""
    return sum(getattr(e, "self_device_time_total", None)
               or getattr(e, "self_cuda_time_total", 0)
               for e in prof.key_averages())


def window_profile(torch, run, label, kernel="decode_split_kernel"):
    """Time one decode window ``run()`` (which returns its steps, its one
    readback included) on the host clock, then profile a second one:
    device busy time (every kernel, copy and fill the profiler records),
    the window's span between CUDA events (busy time plus the card's
    gaps), the idle share (1 - busy / host time) and the kernels that
    take the time.  Kernels replayed from a CUDA graph count only if the
    profiler attributes them: the phase fails unless ``kernel`` (the
    decode kernel's name; None for a model that launches none) is among
    the profile's events."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    k = run()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3 / k
    a = torch.cuda.Event(enable_timing=True)
    z = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        a.record()
        k2 = run()
        z.record()
        torch.cuda.synchronize()
    busy = _device_us(prof) / 1e3 / k2
    span = a.elapsed_time(z) / k2
    check(busy > 0, "the profiler recorded no device time")
    dev = lambda e: (getattr(e, "self_device_time_total", None)
                     or getattr(e, "self_cuda_time_total", 0))
    events = prof.key_averages()
    check(kernel is None or any(kernel in e.key and dev(e) > 0
                                for e in events),
          f"{label}: the profiler attributed no {kernel}")
    top = sorted(events, key=dev, reverse=True)[:6]
    idle = max(0.0, 1 - busy / host)
    log(f"{label}: {host:.2f} ms per step on the host clock, device busy "
        f"{busy:.2f} ms per step (event span {span:.2f}; idle share "
        f"{idle:.2f}); top device time per step: " + "; ".join(
            f"{e.key[:60]} {dev(e) / 1e3 / k2:.3f} ms" for e in top))
    return {"host_ms": host, "busy_ms": busy, "span_ms": span,
            "idle": idle}


def profile_window(torch, engine, reqs, eager=False, pools=False):
    """Where a decode step's time goes on the card: admit one full wave
    into the served engine, settle it with one short window, then time
    and profile decode windows of 8 steps through the engine (replays of
    its captured step, its readback and bookkeeping).  With ``eager``,
    also the same windows run eagerly by ``decode_multi_paged`` on a
    copy of the state (the launches one by one from Python, and the
    readback), after holding its first window to the graphed one bit for
    bit (with ``pools``, the pools too, but for the null block: the idle
    rows' write sink, written in no fixed order).  Then drain."""
    from repro_torch.models import model as M
    from repro_torch.serving.engine import drive_paged
    check(engine.join_many(reqs) == len(reqs), "profile wave refused")
    engine.step_window(max_steps=4)            # first window after a wave
    out = {}
    if eager:
        pages = {key: v.clone() for key, v in engine.pages.items()}
        batch = {"logits": engine.logits.clone(),
                 "positions": engine.positions.clone(),
                 "block_tables": engine.tables.clone(),
                 "active": engine.active_mask.clone()}
        before = [a and len(a["generated"]) for a in engine.active]
        _, _, k = engine.step_window(max_steps=8)
        logits, _, positions, toks = M.decode_multi_paged(
            engine.params, engine.cfg, pages, dict(batch), num_steps=k,
            act_dtype=engine.dtype)
        toks = toks.cpu()
        for slot, a in enumerate(engine.active):
            check(a is None or a["generated"][before[slot]:]
                  == toks[slot].tolist(),
                  f"slot {slot}: graphed and eager windows differ")
        live = engine.active_mask             # finished rows are reset
        check(torch.equal(logits, engine.logits)
              and torch.equal(positions[live], engine.positions[live]),
              "graphed and eager windows differ in logits or positions")
        if pools:
            keep = torch.ones(engine.allocator.num_blocks, dtype=torch.bool,
                              device=logits.device)
            keep[engine.null_block] = False
            check(all(torch.equal(engine.pages[key][:, keep],
                                  pages[key][:, keep]) for key in pages),
                  "graphed and eager windows differ in the pools")
        log(f"graphed and eager {k}-step windows at {engine.num_active} "
            f"rows: tokens, logits, positions"
            f"{' and pools' if pools else ''} bit-equal")

        def run_eager():
            toks = M.decode_multi_paged(
                engine.params, engine.cfg, pages, dict(batch), num_steps=8,
                act_dtype=engine.dtype)[3]
            toks.cpu()
            return 8

        out["eager"] = window_profile(
            torch, run_eager, f"eager decode window at "
            f"{engine.num_active} rows")
        del pages, batch
    out["graphed"] = window_profile(
        torch, lambda: engine.step_window(max_steps=8)[2],
        f"graphed decode window at {engine.num_active} rows")
    st = drive_paged(engine, [])
    check(not engine.num_active and not st["unserved"],
          "profile wave did not drain")
    engine.assert_drained()
    return out


# ---------------------------------------------------------------------------
# phase 14: phase 5's serve on an engine warmed up ahead of time
# ---------------------------------------------------------------------------

def magnus_service(cfg, geometry):
    """The Magnus service over a pool of ``geometry``, set up as
    ``run_paged_engine_backend`` sets it up (the same predictor, memory
    model and shared misprediction EWMA; with phase 5's requests queued
    after the engine is built, as the launcher queues them, phase 5's
    schedule).  Returns the allocator, the service, the EWMA and
    ``drive_paged``'s ``refill`` and ``backlog``."""
    from repro_torch.core.magnus import MagnusConfig, MagnusService
    from repro_torch.core.predictor import GenerationLengthPredictor
    from repro_torch.core.wma import MemoryModel
    from repro_torch.serving.paged_cache import (BlockAllocator,
                                                 MispredictionEWMA)
    from repro_torch.workload.apps import make_dataset
    memory = MemoryModel(cfg, hbm_bytes=2 * 2 ** 30,
                         max_len=geometry["max_len"],
                         max_gen=geometry["max_gen"])
    allocator = BlockAllocator(geometry["num_blocks"],
                               geometry["block_tokens"])
    svc = MagnusService(
        memory, MagnusConfig(strategy="magnus-paged", prefix_sharing=True),
        predictor=GenerationLengthPredictor(seed=0).fit(
            make_dataset(60, seed=1)),
        allocator=allocator)
    ewma = MispredictionEWMA()
    svc.memory.headroom = ewma

    def refill(steps):
        nb = svc.next_batch(now=float(steps))
        return nb.requests if nb is not None else None

    return (allocator, svc, ewma, refill,
            lambda: len(svc.batcher.queue) > 0)


def warmed_serve(torch, reqs, reset_counts, counts):
    """Phase 5's serve again, set up as ``run_paged_engine_backend`` sets
    it up (``magnus_service``: the same service, predictor, pool and
    weights, so the same schedule) but with ``warmup=True``, which the
    launcher does not expose: the engine runs every wave shape and
    captures its decode step before the counts are zeroed.  Returns the
    serve's launches, plain calls, streams, host syncs, windows and
    steps, and the engine's captures before and after the serve."""
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import PagedContinuousEngine, drive_paged
    cfg = get_config("chatglm-6b")
    allocator, svc, ewma, refill, backlog = magnus_service(cfg, SERVE)
    t0 = time.perf_counter()
    engine = PagedContinuousEngine(
        cfg, seed=0, max_concurrency=SERVE["max_concurrency"],
        max_len=SERVE["max_len"], max_gen=SERVE["max_gen"],
        dtype=torch.bfloat16, allocator=allocator,
        prefix_cache=svc.prefix_cache or False, mispredict=ewma,
        device="cuda",
        warmup=True)
    torch.cuda.synchronize()
    captures0 = engine.graph_captures
    log(f"warmed engine: weights and warmup {time.perf_counter() - t0:.1f}"
        f" s, {captures0} capture(s)")
    for r in reqs:
        svc.on_request(r, r.arrival_time)
    t0 = time.perf_counter()
    with replays() as rep:
        reset_counts()
        st = drive_paged(engine, [], max_steps=100_000, refill=refill,
                         backlog=backlog)
        torch.cuda.synchronize()
        launches = counts("launches")
    wall = time.perf_counter() - t0
    tokens = sum(len(g) for g in engine.generated.values())
    log(f"warmed serve: {wall:.2f} s, {tokens / wall:.1f} tokens/s, "
        f"{st['served']} requests, {engine.decode_steps} steps in "
        f"{rep.windows} windows, {st['host_syncs']} host syncs, "
        f"launches {launches}; the host enqueued a replayed step (replay "
        f"and token copy) in {rep.enqueue_s * 1e3 / max(1, rep.replayed_steps):.4f}"
        f" ms on average over {rep.replayed_steps} steps")
    return {"engine": engine, "launches": launches,
            "plain_calls": counts("plain_calls"), "stats": st,
            "windows": rep.windows, "replayed_steps": rep.replayed_steps,
            "captures": (captures0, engine.graph_captures)}


# ---------------------------------------------------------------------------
# phase 15: the chaos serve (the §14 lifecycle and the §15 host swap tier)
# ---------------------------------------------------------------------------

# a pool of 128 blocks (30 of phase 5's requests fit at once, with their
# shared heads) and a host tier of as many (0.94 GB pinned at chatglm-6b's
# 7.3 MB a block); the deadline lets the first wave finish and sheds the
# requests that a suspension or a restart plus the stall hold past it
CHAOS = dict(num_blocks=128, block_tokens=16, max_concurrency=32,
             max_len=512, max_gen=128)
CHAOS_SWAP_BLOCKS = 128
CHAOS_TTL = 60                 # scheduler-clock ticks from admission
TWIN = dict(num_blocks=512, block_tokens=16, max_concurrency=32,
            max_len=512, max_gen=128)
POISON_SLOT, SWAP_SLOT = 5, 9  # the twin checks' victims
GUARD_REPS = 20


def chaos_plan(FaultEvent):
    """Every fault kind of the lifecycle and the tier, in one serve of 7
    decode windows: an under-prediction storm on one app (x0.25 from the
    first admission), a poisoned slot, a pool shrink (suspensions), a
    host tier squeezed to 8 blocks (so later victims are destroyed), two
    stalled resumes, a stall, then both restores."""
    return [FaultEvent(window=0, kind="predict_skew", app="head1",
                       factor=0.25),
            FaultEvent(window=2, kind="poison_logits"),
            FaultEvent(window=3, kind="pool_shrink", blocks=40),
            FaultEvent(window=4, kind="host_pressure", blocks=120),
            FaultEvent(window=4, kind="swap_stall", ticks=2),
            FaultEvent(window=6, kind="stall", ticks=24),
            FaultEvent(window=7, kind="host_pressure", blocks=0),
            FaultEvent(window=7, kind="pool_restore")]


class wave_shapes:
    """Inside the ``with`` block every admission wave of a paged engine
    records, for each request it prefills, the KV's lineage: the wave's
    shape (its rows, the power-of-two batch, and its suffix bucket), the
    request's cached prefix tokens, and the lineage of every block its
    cached prefix shares (or clones), as recorded when that block was
    written.  A bf16 prefill in a wave of another shape (another GEMM M)
    may round differently, and so may everything computed on its KV.
    ``by_req`` maps a req_id to the lineages of its admissions (a
    restarted request has more than one)."""

    def __init__(self):
        self.by_req = {}
        self.written = {}      # block -> the lineage of its writer

    def __enter__(self):
        from repro_torch.serving import engine as E
        self.orig = orig = E.PagedContinuousEngine._dispatch_wave

        def record(engine, plans):
            nb = E._pow2_ceil(len(plans))
            sb = E._bucket(max(len(p["ids"]) - p["cached"] for p in plans))
            lines = []
            for p in plans:
                full = p["cached"] // engine.bt
                src = list(p["table"][:full]) + (
                    [p["cow"][0]] if p["cow"] is not None else [])
                line = (nb, sb, p["cached"],
                        tuple(self.written.get(b) for b in src))
                self.by_req.setdefault(p["req"].req_id, []).append(line)
                lines.append(line)
            out = orig(engine, plans)
            for p, line in zip(plans, lines):
                for b in p["table"][p["cached"] // engine.bt:]:
                    self.written[b] = line
            return out

        E.PagedContinuousEngine._dispatch_wave = record
        return self

    def __exit__(self, *exc):
        from repro_torch.serving import engine as E
        E.PagedContinuousEngine._dispatch_wave = self.orig


def _sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def block_bytes(engine) -> int:
    """Bytes of one block across the pools (every layer, K and V)."""
    return sum(p[:, 0].numel() * p.element_size()
               for p in engine.pages.values())


def chaos_serve(torch, cfg, params, device, dtype, reset_counts, counts,
                plan=None, warmup=False):
    """Phase 5's 48 requests (predictions exact, but for the skewed app)
    straight through ``drive_paged`` on a faulted engine with a host
    tier and deadlines (built with ``warmup``).  Counts are zeroed just
    before and read just after.  Each swap-out is timed on the host (it
    waits for its copies); every wave's KV lineage is recorded, and
    so are the layer-0 inputs of every decode step and admission wave
    (as in phase 5), for :func:`hold_chaos`.  Returns what the checks
    and the log need."""
    from repro_torch.models import transformer
    from repro_torch.serving.engine import PagedContinuousEngine, drive_paged
    from repro_torch.serving.faults import FaultEvent, FaultInjector
    from repro_torch.workload.apps import make_shared_head_dataset
    reqs = make_shared_head_dataset(N_REQUESTS, n_apps=3,
                                    gen_length=GEN_LENGTH, seed=0)
    inj = FaultInjector(plan if plan is not None else chaos_plan(FaultEvent))
    t0 = time.perf_counter()
    engine = PagedContinuousEngine(
        cfg, params, device=device, dtype=dtype, faults=inj,
        default_ttl=CHAOS_TTL, swap_blocks=CHAOS_SWAP_BLOCKS,
        prefix_cache=True, warmup=warmup, **CHAOS)
    build_s = time.perf_counter() - t0
    swap_out, outs, queued = engine._swap_out, [], []

    def timed_swap_out(slot):
        # whether device work was still queued (the swap-out's wait for
        # its copies waits for that work too); asks, does not wait
        busy = (torch.device(device).type == "cuda"
                and not torch.cuda.current_stream().query())
        t0, s0 = time.perf_counter(), engine.host_syncs
        b0 = engine.swapped_blocks
        ok = swap_out(slot)
        if ok:
            outs.append((time.perf_counter() - t0, engine.host_syncs - s0,
                         engine.swapped_blocks - b0))
            queued.append(busy)
        return ok

    engine._swap_out = timed_swap_out
    decoded, waves = paged_recorders(transformer, cfg.num_layers)
    _sync(torch, device)
    t0 = time.perf_counter()
    with decoded, waves, replays(decoded) as rep, wave_shapes() as shapes:
        reset_counts()
        st = drive_paged(engine, list(reqs), max_steps=100_000)
        _sync(torch, device)
        launches = counts("launches")
    wall = time.perf_counter() - t0
    inj.release(engine.allocator)
    # the timer closes over the engine: leaving it in place would keep
    # the engine, its pools and its weights alive until a collection
    del engine._swap_out
    return {"engine": engine, "reqs": reqs, "stats": st, "inj": inj,
            "launches": launches, "plain_calls": counts("plain_calls"),
            "wall": wall, "windows": rep.windows, "outs": outs,
            "build_s": build_s, "queued": queued,
            "shapes": shapes.by_req, "decoded": decoded, "waves": waves}


def hold_chaos(torch, ops, ref, r):
    """Phase 15: every decode step and admission wave of the chaos serve
    (its row counts, suffix buckets, re-admissions with their radix
    hits, resumed slots' scattered tables), recorded at layer 0, through
    each paged kernel and its plain version on the chaos engine's
    pools, held as phase 6 holds phase 5's (``hold``).  The recorders
    must have seen every step and wave.  Returns the largest error of
    each kernel."""
    eng, decoded, waves = r["engine"], r["decoded"], r["waves"]
    check(len(decoded.kept) == eng.decode_steps
          and len(waves.kept) == eng.prefill_dispatches,
          f"recorded {len(decoded.kept)} decode steps and "
          f"{len(waves.kept)} waves of {eng.decode_steps} and "
          f"{eng.prefill_dispatches}")
    K, V = eng.pages["k"][0], eng.pages["v"][0]
    errs = {"paged_decode_attention": [],
            "paged_prefix_prefill_attention": []}
    for q, tables, lens in decoded.kept:
        errs["paged_decode_attention"].append(hold(
            torch, "paged_decode_attention",
            ops.paged_decode_attention(q, K, V, tables, lens),
            ref.paged_decode_attention_ref(q, K, V, tables, lens)))
    for q, ks, vs, tables, pl, sl in waves.kept:
        errs["paged_prefix_prefill_attention"].append(hold(
            torch, "paged_prefix_prefill_attention",
            ops.paged_prefix_prefill_attention(q, ks, vs, K, V, tables,
                                               pl, sl),
            ref.paged_prefix_prefill_attention_ref(q, ks, vs, K, V, tables,
                                                   pl, sl)))
    log("chaos holds (layer-0 inputs, the chaos engine's layer-0 pools): "
        + "; ".join(f"{name} at {len(e)} served shapes, max abs err "
                    f"{max(x for x, _ in e):.3e} at output scale up to "
                    f"{max(sc for _, sc in e):.1f}"
                    for name, e in errs.items()))
    return {name: max(x for x, _ in e) for name, e in errs.items()}


def check_chaos(torch, r, layers):
    """Phase 15's check 1, the contract: nothing unserved, every request
    served or shed with a known reason, every fault kind seen, both
    tiers drained, one capture (on the card), the kernels launched once
    per layer and step or wave and no plain version ran, and the host
    syncs exactly one per decode window, one per NaN-guard readback (the
    engine counts them, at most one a window) and two per swap-out (one
    if it had no page to copy)."""
    from repro_torch.core.types import SHED_REASONS
    eng, st = r["engine"], r["stats"]
    check(not st["unserved"], f"{len(st['unserved'])} requests unserved")
    check(st["served"] + len(st["shed"]) == N_REQUESTS,
          f"{st['served']} served + {len(st['shed'])} shed != {N_REQUESTS}")
    check(all(s.reason in SHED_REASONS for s in st["shed"]),
          "a shed without a known reason")
    seen = {name: getattr(eng, name) for name in (
        "swap_outs", "swap_ins", "quarantined", "deadline_misses",
        "evictions", "stall_ticks")}
    check(all(seen.values()), f"a fault path never ran: {seen}")
    eng.assert_drained()
    check(eng.swap.empty, "the host tier is not empty")
    if eng.device.type == "cuda":
        check(eng.graph_captures == 1,
              f"{eng.graph_captures} captures of the decode step")
    check(r["launches"]["paged_decode_attention"]
          == layers * eng.decode_steps
          and r["launches"]["paged_prefix_prefill_attention"]
          == layers * eng.prefill_dispatches,
          f"chaos launches {r['launches']} against {eng.decode_steps} "
          f"steps and {eng.prefill_dispatches} waves")
    check(not any(r["plain_calls"].values()),
          f"plain versions ran in the chaos serve: {r['plain_calls']}")
    swap_syncs = sum(s for _, s, _ in r["outs"])
    check(len(r["outs"]) == eng.swap_outs
          and all(s == (2 if b else 1) for _, s, b in r["outs"]),
          f"swap-outs (host s, syncs, fresh blocks) {r['outs']}: not one "
          f"readback for the logits row and one for the pages, if any")
    guard = eng.guard_readbacks
    check(r["windows"] <= guard <= eng.windows
          and st["host_syncs"] == r["windows"] + guard + swap_syncs,
          f"host syncs {st['host_syncs']}: not {r['windows']} decode "
          f"windows + {guard} guard readbacks (in {eng.windows} windows) "
          f"+ {swap_syncs} swap-out readbacks")
    for rid, toks in eng.generated.items():
        check(len(toks) == GEN_LENGTH
              and all(0 <= t < eng.cfg.vocab_size for t in toks),
              f"request {rid}: {len(toks)} tokens or one out of range")
    return guard


def compare_streams(reqs, generated, shapes, reqs5, streams5, shapes5):
    """Phase 15's check 4: each finished stream (``generated``) against
    the unfaulted serve's for the same request; each that differs is put
    down to a restart (re-prefilled), to its one admission's KV lineage
    differing from the unfaulted serve's (``wave_shapes``), or to
    neither.  Returns (equal count, restarted, other lineage, same
    lineage) as request indices."""
    same, restarted, other, unexplained = 0, [], [], []
    for i, req in enumerate(reqs):
        toks = generated.get(req.req_id)
        if toks is None:
            continue
        if toks == streams5[i]:
            same += 1
            continue
        lines = shapes.get(req.req_id, [])
        if len(lines) > 1:
            restarted.append(i)
        elif lines != shapes5.get(reqs5[i].req_id, []):
            other.append(i)
        else:
            unexplained.append(i)
    return same, restarted, other, unexplained


def shed_list(r):
    """The chaos serve's sheds in order, as (request index, reason)."""
    index = {q.req_id: i for i, q in enumerate(r["reqs"])}
    return [(index[x.req.req_id], x.reason) for x in r["stats"]["shed"]]


def f32_witness(torch, cfg, reset_counts, counts, served5, chaos16):
    """Phase 15's witness for check 4, in f32 (TF32 off) on one weight
    set: phase 5's serve (its launcher, geometry, requests and seed, so
    its schedule: steps, waves, windows and host syncs must equal phase
    5's), whose admission waves' KV lineages stand for phase 5's, then
    the chaos serve.  The chaos serve's schedule is length-scripted, so
    its counters and sheds must equal the bf16 chaos serve's; its
    streams are compared with the f32 serve's by ``compare_streams``,
    as the bf16 ones with phase 5's.  Returns phase 5's lineages, that
    comparison, the f32 chaos serve's wall time and the f32 serve's
    streams (in request order: phase 16's f32 witness compares with
    them)."""
    from repro_torch.launch.serve import run_paged_engine_backend
    from repro_torch.models import model as M
    from repro_torch.workload.apps import make_shared_head_dataset
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is on for f32 GEMMs")
    log(f"f32 witness: {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
        f"allocated before its weights")
    params = M.init_params(cfg, seed=0, device="cuda", dtype=torch.float32)
    reqs = make_shared_head_dataset(N_REQUESTS, n_apps=3,
                                    gen_length=GEN_LENGTH, seed=0)
    with wave_shapes() as shapes5:
        res = run_paged_engine_backend(
            "chatglm-6b", 0.0, 0.0, "magnus-paged", seed=0, reduced=False,
            device="cuda", dtype=torch.float32, prefix_cache=True,
            requests=reqs, params=params, **SERVE)
    eng = res.pop("engine")
    sched = (eng.decode_steps, eng.prefill_dispatches, res["host_syncs"])
    check(sched == (served5["steps"], served5["waves"],
                    served5["host_syncs"]),
          f"the f32 serve's steps, waves and host syncs {sched}: not "
          f"phase 5's {served5['steps'], served5['waves']}, "
          f"{served5['host_syncs']}")
    eng.assert_drained()
    streams = [eng.generated[r.req_id] for r in reqs]
    del eng, res
    torch.cuda.empty_cache()
    r = chaos_serve(torch, cfg, params, "cuda", torch.float32,
                    reset_counts, counts)
    del params
    eng = r["engine"]
    names = ("decode_steps", "prefill_dispatches", "evictions",
             "quarantined", "deadline_misses", "stall_ticks", "swap_outs",
             "swap_ins", "swapped_blocks", "host_syncs")
    mine = {n: getattr(eng, n) for n in names}
    check(mine == chaos16["counters"]
          and shed_list(r) == chaos16["sheds"],
          f"the f32 chaos serve's counters {mine} or sheds differ from "
          f"the bf16 one's {chaos16['counters']}")
    eng.assert_drained()
    cmp = compare_streams(r["reqs"], eng.generated, r["shapes"], reqs,
                          streams, shapes5.by_req)
    wall = r["wall"]
    del r, eng
    torch.cuda.empty_cache()
    return shapes5.by_req, cmp, wall, streams


def _twins(torch, cfg, params, device, dtype, plans, **kw):
    """Two engines admitted identically (the first 32 of phase 5's
    requests in one wave) and run one 2-step window (the capture);
    ``plans`` gives each its fault plan."""
    import copy
    from repro_torch.serving.engine import PagedContinuousEngine
    from repro_torch.serving.faults import FaultInjector
    from repro_torch.workload.apps import make_shared_head_dataset
    reqs = make_shared_head_dataset(TWIN["max_concurrency"], n_apps=3,
                                    gen_length=GEN_LENGTH, seed=0)
    out = []
    for plan in plans:
        eng = PagedContinuousEngine(
            cfg, params, device=device, dtype=dtype, prefix_cache=True,
            faults=FaultInjector(plan), **TWIN, **kw)
        check(eng.join_many(copy.deepcopy(reqs)) == len(reqs),
              "a twin engine refused its wave")
        eng.step_window(max_steps=2)
        out.append(eng)
    a, b = out
    check(all(x["generated"] == y["generated"]
              for x, y in zip(a.active, b.active)),
          "the twin engines' first windows differ")
    return a, b


def _same_window(torch, a, b, skip=()):
    """One 4-step window on both twins: the same steps, and bit-equal
    tokens and logits on every slot not in ``skip``."""
    _, ea, ka = a.step_window(max_steps=4)
    _, eb, kb = b.step_window(max_steps=4)
    check(ka == kb == 4, f"twin windows of {ka} and {kb} steps")
    keep = [s for s in range(a.slots) if s not in skip]
    for s in keep:
        check(a.active[s]["generated"] == b.active[s]["generated"],
              f"slot {s}: the twins' tokens differ")
    check(torch.equal(a.logits[keep], b.logits[keep]),
          "the twins' logits differ")
    return ea, eb


def quarantine_check(torch, cfg, params, device, dtype):
    """Phase 15's check 2: poison slot ``POISON_SLOT`` of twin A in its
    second window; A quarantines exactly that slot's request, and every
    other slot's tokens and logits after the window equal twin B's, bit
    for bit.  Then the guard's readback, timed alone on B's logits."""
    from repro_torch.serving.faults import FaultEvent
    a, b = _twins(torch, cfg, params, device, dtype,
                  [[FaultEvent(window=2, kind="poison_logits",
                               slot=POISON_SLOT)], []])
    victim = a.active[POISON_SLOT]["req"].req_id
    ea, eb = _same_window(torch, a, b, skip=(POISON_SLOT,))
    check(a.quarantined == 1 and [r.req_id for r in ea] == [victim]
          and b.quarantined == 0 and not eb,
          f"quarantine: A {a.quarantined} ({[r.req_id for r in ea]}), "
          f"B {b.quarantined}")
    _sync(torch, device)
    t0 = time.perf_counter()
    for _ in range(GUARD_REPS):
        torch.isfinite(b.logits).all(dim=1).cpu()
    guard_ms = (time.perf_counter() - t0) * 1e3 / GUARD_REPS
    log(f"quarantine: slot {POISON_SLOT} poisoned, request {victim} "
        f"quarantined; the other {a.slots - 1} slots' tokens and logits "
        f"bit-equal to the unpoisoned twin's; the guard's readback of "
        f"{tuple(b.logits.shape)} {b.logits.dtype} logits as {a.slots} "
        f"flags: {guard_ms:.4f} host ms")
    return guard_ms


def swap_roundtrip_check(torch, cfg, params, device, dtype):
    """Phase 15's check 3: twin A suspends slot ``SWAP_SLOT`` and resumes
    it with no admission between; its pages through its new table, its
    logits row and position equal twin B's bit for bit, its prefill
    tokens do not move, and the next window equals B's on every slot.
    The suspension (gather and two synchronous copies to pinned memory)
    and the resume (scatter, restore, synchronised) are timed."""
    from repro_torch.models import model as M
    a, b = _twins(torch, cfg, params, device, dtype, [[], []],
                  swap_blocks=CHAOS_SWAP_BLOCKS)
    pt0, s = a.prefill_tokens, SWAP_SLOT
    rid = a.active[s]["req"].req_id
    _sync(torch, device)
    t0 = time.perf_counter()
    check(a._swap_out(s) and a.active[s] is None,
          "the twin's suspension was refused")
    t_out = time.perf_counter() - t0
    image = a.swapped_blocks * block_bytes(a)
    back = len(a.swap.split_resident(rid)[1]) * block_bytes(a)
    _sync(torch, device)
    t0 = time.perf_counter()
    check(a._resume_swapped() == 1 and a.active[s] is not None,
          "the suspended slot did not resume into its slot")
    _sync(torch, device)
    t_in = time.perf_counter() - t0
    check(a.prefill_tokens == pt0, "the resume re-prefilled tokens")
    pages = [M.gather_pages(e.pages, torch.tensor(
        e.allocator.tables[s], device=e.device)) for e in (a, b)]
    check(torch.equal(*pages), "the resumed pages differ from the twin's")
    check(torch.equal(a.logits[s], b.logits[s])
          and torch.equal(a.positions, b.positions)
          and int(a.pos_host[s]) == int(b.pos_host[s]),
          "the resumed logits row or position differs")
    _same_window(torch, a, b)
    log(f"swap round trip: slot {s}, {a.swapped_blocks} blocks "
        f"({image / 2 ** 20:.1f} MiB) suspended in {t_out * 1e3:.2f} host "
        f"ms ({image / t_out / 1e9:.2f} GB/s); {back / 2 ** 20:.1f} MiB "
        f"of it scattered back (the rest still device-resident under the "
        f"tier's holds) in a resume of {t_in * 1e3:.2f} ms synchronised "
        f"({back / t_in / 1e9:.2f} GB/s); pages, logits and positions "
        f"bit-equal to the twin's, no token re-prefilled, the next window "
        f"bit-equal on every slot")


def log_chaos(r, guard, res5_wall, res5_tp):
    """Phase 15's numbers, beside phase 5's serve of the same requests."""
    eng, st = r["engine"], r["stats"]
    tokens = sum(len(g) for g in eng.generated.values())
    outs = r["outs"]
    out_ms = [t * 1e3 for t, _, _ in outs]
    bb = block_bytes(eng)
    reasons = {}
    for sh in st["shed"]:
        reasons[sh.reason] = reasons.get(sh.reason, 0) + 1
    log(f"chaos serve: {r['wall']:.2f} s, {tokens / r['wall']:.1f} tokens/s"
        f" ({st['served']} served, shed {reasons}; phase 5: "
        f"{res5_wall} s, {res5_tp} tokens/s); {eng.decode_steps} steps in "
        f"{r['windows']} decode windows of {eng.windows}; fired "
        f"{r['inj'].fired}")
    log(f"chaos counters: " + json.dumps({n: getattr(eng, n) for n in (
        "evictions", "quarantined", "deadline_misses", "stall_ticks",
        "swap_outs", "swap_ins", "swapped_blocks", "swap_reused_blocks",
        "swapped_ctx_tokens", "reprefilled_swapped_tokens",
        "requeue_prefix_hits", "prefill_dispatches", "prefill_tokens",
        "graph_captures")}) + f", injector {r['inj'].counters()}")
    log(f"chaos host syncs {st['host_syncs']} = {r['windows']} decode "
        f"windows + {guard} NaN-guard readbacks + "
        f"{sum(s for _, s, _ in outs)} swap-out readbacks "
        f"({len(outs)} swap-outs)")
    if outs:
        blocks = sum(b for _, _, b in outs)
        log(f"chaos swap-outs: host ms each {[round(m, 2) for m in out_ms]}"
            f" (device work queued ahead of each: {r['queued']}), mean {statistics.mean(out_ms):.2f} ms for "
            f"{blocks / len(outs) * bb / 2 ** 20:.1f} MiB an image "
            f"({blocks * bb / 1e9 / (sum(out_ms) / 1e3):.2f} GB/s); "
            f"resumes: {eng.swap_in_s * 1e3 / max(1, eng.swap_ins):.2f} host "
            f"ms each to enqueue; pinned tier "
            f"{eng.swap._store.nbytes / 2 ** 30:.2f} GiB "
            f"({CHAOS_SWAP_BLOCKS} blocks of {bb / 2 ** 20:.2f} MiB), "
            f"pinned when the engine was built, which took "
            f"{r['build_s']:.2f} s")


def log_streams(cmps):
    """Phase 15's check 4, each comparison of ``compare_streams``."""
    for label, (same, restarted, other, unexplained) in cmps:
        log(f"chaos streams against the unfaulted serve's, {label}: "
            f"{same} equal; differ: {len(restarted)} restarted "
            f"(re-prefilled; requests {restarted}), {len(other)} with "
            f"another KV lineage than unfaulted (the wave's rows or "
            f"suffix bucket, or the waves that wrote its cached prefix; "
            f"requests {other}), {len(unexplained)} with the same lineage "
            f"(requests {unexplained})")


# ---------------------------------------------------------------------------
# phase 16: speculative decoding (§16), the window as one captured graph
# ---------------------------------------------------------------------------

class LayerZero:
    """Inside the ``with`` block, the layer-0 attention calls of a
    speculative serve are kept, by kind ("decode" or "prefill") and
    pool: a call of ``paged_decode_attention`` or
    ``paged_prefix_prefill_attention`` whose K pages are layer 0 of one
    of ``pools`` ({name: K pool [L, ...]}) keeps a copy of its inputs
    but the pools.  A call made while a graph is captured runs nothing:
    its inputs are cloned inside the capture (so each replay leaves that
    replay's values in the clones), and after every replay of a captured
    step (``CapturedStep.replay``, the engine's speculative window) they
    are kept as that replay's calls."""

    POOL_ARGS = {"decode": (1, 2), "prefill": (3, 4)}

    def __init__(self, transformer, pools):
        self.transformer = transformer
        self.layer0 = {k[0].data_ptr(): name for name, k in pools.items()}
        self.kept, self.captured = {}, []

    def calls(self, kind, pool):
        return self.kept.get((kind, pool), [])

    def _copy(self, kind, args):
        keep = self.POOL_ARGS[kind]
        return tuple(a if i in keep else a.clone() for i, a in enumerate(args))

    def __enter__(self):
        from repro_torch.serving.graphs import CapturedStep
        t = self.transformer
        self.orig = {kind: getattr(t, name) for kind, name in (
            ("decode", "paged_decode_attention"),
            ("prefill", "paged_prefix_prefill_attention"))}
        self.orig_replay = replay = CapturedStep.replay

        def wrap(kind):
            fn = self.orig[kind]

            def call(*args, **kw):
                name = self.layer0.get(args[self.POOL_ARGS[kind][0]]
                                       .data_ptr())
                if name is not None:
                    item = ((kind, name), self._copy(kind, args))
                    if _capturing():
                        self.captured.append(item)
                    else:
                        self.kept.setdefault(item[0], []).append(item[1])
                return fn(*args, **kw)
            return call

        def replay_and_keep(graph):
            replay(graph)
            for key, args in self.captured:
                self.kept.setdefault(key, []).append(
                    self._copy(key[0], args))

        t.paged_decode_attention = wrap("decode")
        t.paged_prefix_prefill_attention = wrap("prefill")
        CapturedStep.replay = replay_and_keep
        return self

    def __exit__(self, *exc):
        from repro_torch.serving.graphs import CapturedStep
        self.transformer.paged_decode_attention = self.orig["decode"]
        self.transformer.paged_prefix_prefill_attention = self.orig["prefill"]
        CapturedStep.replay = self.orig_replay


def hold_spec(torch, ops, ref, label, eng, rec, w):
    """Every kept layer-0 call of a speculative serve through its kernel
    and plain version (phase 6's ``hold``) on its own pool's layer 0:
    the draft's decode steps, the target's verifies (S = W) and waves,
    the draft's waves.  Checks that the recorder saw every call: W draft
    steps and one verify a window, one target and one draft wave per
    admission wave, no decode on the target pool.  Returns the verifies
    and the draft steps, and the largest error of each kernel."""
    pools = {"target": eng.pages, "draft": eng.draft_pages}
    verifies = [c for c in rec.calls("prefill", "target")
                if c[0].shape[1] == w]
    waves = [c for c in rec.calls("prefill", "target")
             if c[0].shape[1] != w]
    steps = rec.calls("decode", "draft")
    check(len(steps) == w * eng.spec_windows
          and len(verifies) == eng.spec_windows
          and len(waves) == eng.prefill_dispatches
          == len(rec.calls("prefill", "draft"))
          and not rec.calls("decode", "target"),
          f"{label}: recorded {len(steps)} draft steps, {len(verifies)} "
          f"verifies, {len(waves)} and {len(rec.calls('prefill', 'draft'))}"
          f" waves, {len(rec.calls('decode', 'target'))} target decodes for"
          f" {eng.spec_windows} windows and {eng.prefill_dispatches} waves")
    errs = {"paged_decode_attention": [],
            "paged_prefix_prefill_attention": []}
    for (kind, pool), calls in rec.kept.items():
        K, V = pools[pool]["k"][0], pools[pool]["v"][0]
        for args in calls:
            if kind == "decode":
                q, _, _, tables, lens = args
                errs["paged_decode_attention"].append(hold(
                    torch, "paged_decode_attention",
                    ops.paged_decode_attention(q, K, V, tables, lens),
                    ref.paged_decode_attention_ref(q, K, V, tables, lens)))
            else:
                q, ks, vs, _, _, tables, pl, sl = args
                errs["paged_prefix_prefill_attention"].append(hold(
                    torch, "paged_prefix_prefill_attention",
                    ops.paged_prefix_prefill_attention(
                        q, ks, vs, K, V, tables, pl, sl),
                    ref.paged_prefix_prefill_attention_ref(
                        q, ks, vs, K, V, tables, pl, sl)))
    log(f"{label} holds (layer-0 inputs on their own pools): " + "; ".join(
        f"{name} at {len(e)} calls, max abs err {max(x for x, _ in e):.3e} "
        f"at output scale up to {max(sc for _, sc in e):.1f}"
        for name, e in errs.items()))
    return ([(q, ks, vs, t, pl, sl) for q, ks, vs, _, _, t, pl, sl
             in verifies],
            [(q, t, lens) for q, _, _, t, lens in steps],
            {name: max(x for x, _ in e) for name, e in errs.items()})


def spec_counts(label, eng, launches, plain, stats):
    """The phase's exact count checks: one capture (the first window's),
    host syncs = spec windows (no guard without faults), the kernels
    launched W times a window per draft layer and once a verify, target
    wave and draft wave per target layer (draft layer for the draft's
    waves), no plain call, no plain decode graph."""
    w, lt, ld = eng.spec_w, eng.cfg.num_layers, eng.draft_cfg.num_layers
    windows, waves = eng.spec_windows, eng.prefill_dispatches
    want = {"paged_decode_attention": ld * w * windows,
            "paged_prefix_prefill_attention":
                lt * (waves + windows) + ld * waves}
    got = {name: launches[name] for name in want}
    check(got == want, f"{label}: launches {got}, predicted {want} from "
          f"{windows} windows and {waves} waves")
    check(not any(plain.values()), f"{label}: plain calls {plain}")
    check(eng.graph_captures == 1 and eng._decode_graph is None,
          f"{label}: {eng.graph_captures} captures")
    check(stats["host_syncs"] == windows,
          f"{label}: {stats['host_syncs']} host syncs in {windows} windows")
    log(f"{label}: {windows} spec windows, {waves} waves, "
        f"{eng.decode_steps} decode steps, {stats['host_syncs']} host "
        f"syncs, 1 capture; launches {got} as predicted; acceptance "
        f"{stats['acceptance_rate']:.4f}, {stats['accepted_per_dispatch']:.4f}"
        f" tokens a verify row; draft prefill tokens "
        f"{eng.draft_prefill_tokens}")


def spec_profile(torch, engine, reqs):
    """Where a speculative window's time goes: admit one full wave into
    the served engine, settle it with one window, then time and profile
    windows through the engine (replays of the captured window, its
    readback and bookkeeping), and the draft's W steps and the verify
    apart, each run eagerly on a copy of the window's state (their
    device busy time; their writes land where the next window writes
    anyway).  Then drain."""
    from repro_torch.models import model as M
    from repro_torch.serving.engine import drive_paged
    check(engine.join_many(reqs) == len(reqs), "profile wave refused")
    engine.step_window()
    out = {"graphed": window_profile(
        torch, lambda: (engine.step_window(), 1)[1],
        f"graphed spec window at {engine.num_active} rows")}
    g = engine._spec_graph
    st = {k: t.clone() for k, t in g.state.items()}
    st["max_emit"].fill_(engine.spec_w)
    proposed, packed = g.proposed.clone(), g.packed.clone()

    def draft():
        M.draft_window_into(
            engine.draft_params, engine.draft_cfg, engine.draft_pages,
            {"target_logits": st["logits"], "logits": st["draft_logits"],
             "positions": st["positions"], "tables": st["draft_tables"],
             "active": st["active"]},
            proposed, target_vocab=engine.cfg.vocab_size,
            act_dtype=engine.dtype)
        return 1

    def verify():
        s = {k: st[k].clone() for k in ("logits", "positions")}
        M.verify_window_into(
            engine.params, engine.cfg, engine.pages,
            {**s, "tables": st["tables"], "active": st["active"],
             "max_emit": st["max_emit"]},
            proposed, packed, null_block=engine.null_block,
            act_dtype=engine.dtype)
        return 1

    out["eager draft"] = window_profile(
        torch, draft, f"eager draft steps (W = {engine.spec_w})")
    out["eager verify"] = window_profile(
        torch, verify, "eager verify", kernel="prefix_prefill_tc_kernel")
    # the margin a greedy pick has against rounding: the gap between the
    # two largest logits of each active row's carry
    live = st["active"]
    top = torch.topk(st["logits"][live, :engine.cfg.vocab_size].float(),
                     2).values
    gap = top[:, 0] - top[:, 1]
    log(f"spec window: the target's top-2 logit gap over {gap.numel()} "
        f"rows: median {gap.median().item():.3f}, under 0.25 in "
        f"{(gap < 0.25).float().mean().item():.2f} of the rows, largest "
        f"logit up to {top[:, 0].max().item():.1f}")
    del st
    s = drive_paged(engine, [])
    check(not engine.num_active and not s["unserved"],
          "spec profile wave did not drain")
    engine.assert_drained()
    return out


def spec_serve(torch, reqs, reset_counts, counts):
    """Phase 16 (a): phase 5's serve through the launcher with
    ``spec_decode=True``, a self-draft, recording every layer-0 call and
    every wave's KV lineage."""
    from repro_torch.launch.serve import run_paged_engine_backend
    from repro_torch.models import transformer
    from repro_torch.serving import engine as E
    made = []
    build = E.PagedContinuousEngine.__init__

    def record(engine, *a, **kw):
        build(engine, *a, **kw)
        made.append(engine)
        rec.layer0.update({engine.pages["k"][0].data_ptr(): "target",
                           engine.draft_pages["k"][0].data_ptr(): "draft"})

    rec = LayerZero(transformer, {})
    E.PagedContinuousEngine.__init__ = record
    try:
        with rec, wave_shapes() as shapes:
            reset_counts()
            res = run_paged_engine_backend(
                "chatglm-6b", 0.0, 0.0, "magnus-paged", seed=0,
                reduced=False, device="cuda", dtype=torch.bfloat16,
                prefix_cache=True, requests=reqs, spec_decode=True,
                draft_k=DRAFT_K, **SERVE)
            launches = counts("launches")
    finally:
        E.PagedContinuousEngine.__init__ = build
    eng = res.pop("engine")
    check(made == [eng], "the launcher built another engine")
    return eng, res, rec, shapes.by_req, launches, counts("plain_calls")


def small_draft_serve(torch, cfg, params, reqs, reset_counts, counts):
    """Phase 16 (b): the rejecting draft (chatglm-6b cut to
    ``SMALL_DRAFT``, seed 1) through ``PagedContinuousEngine`` and
    ``drive_paged`` at phase 5's geometry, as phase 15 drives its
    engine."""
    import dataclasses
    from repro_torch.models import transformer
    from repro_torch.serving.engine import PagedContinuousEngine, drive_paged
    # reduced() also cuts the vocab; the draft keeps the target's
    dcfg = dataclasses.replace(cfg.reduced(**SMALL_DRAFT),
                               vocab_size=cfg.vocab_size)
    eng = PagedContinuousEngine(
        cfg, params, device="cuda", dtype=torch.bfloat16, prefix_cache=True,
        spec_decode=True, draft_k=DRAFT_K, draft_cfg=dcfg, draft_seed=1,
        **SERVE)
    check(dcfg.vocab_size == cfg.vocab_size and dcfg.head_dim == 64,
          f"the small draft: vocab {dcfg.vocab_size}, head {dcfg.head_dim}")
    rec = LayerZero(transformer, {"target": eng.pages["k"],
                                  "draft": eng.draft_pages["k"]})
    t0 = time.perf_counter()
    with rec:
        reset_counts()
        st = drive_paged(eng, list(reqs), max_steps=100_000)
        torch.cuda.synchronize()
        launches = counts("launches")
    wall = time.perf_counter() - t0
    return eng, st, rec, launches, counts("plain_calls"), wall


def spec_f32_witness(torch, cfg, reqs, streams32):
    """Phase 16 (c): phase 5's requests through the launcher in f32
    (TF32 off) on phase 15's f32 weights (seed 0), at a pool of
    ``SPEC_F32_BLOCKS``, inside ``batch_invariant()``: spec off, then
    spec on with a self-draft.  Every spec-on stream must equal the
    spec-off serve's, and the self-draft must have every proposal
    accepted (acceptance 1.0).

    The batch-invariant arithmetic is what makes "equal" a test of the
    speculative logic: with the default arithmetic a verify (products
    of B x W rows, the prefix-prefill kernel) and a decode step
    (products of B rows, the decode kernel) round differently even in
    f32, and at a near tie of two logits the greedy pick flips
    (``scripts/f32_invariance.py`` measures both).  Before the verdict
    it logs what a failure is made of: each differing stream's first
    differing token, and each rejected proposal (the draft's token
    against the verify's pick) with the gap between the two in the
    verify's own carried logits, read back after the window on the card.
    The spec-off streams are also compared, for the log only, with phase
    15's f32 serve (``streams32``, the default arithmetic): that count
    measures how often rounding alone changes a stream."""
    from repro_torch.launch.serve import run_paged_engine_backend
    from repro_torch.models import model as M
    from repro_torch.serving import engine as E
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is on for f32 GEMMs")
    params = M.init_params(cfg, seed=0, device="cuda", dtype=torch.float32)
    serve = dict(SERVE, num_blocks=SPEC_F32_BLOCKS)
    rejections, speculate = [], E.PagedContinuousEngine._speculate

    def watched(engine, max_emit):
        packed = speculate(engine, max_emit)
        # more readbacks a window, not counted by the engine
        rows = packed.cpu().numpy()
        carry = engine.logits[:, :cfg.vocab_size].cpu()
        w = engine.spec_w
        for slot, a in enumerate(engine.active):
            e = int(rows[slot, w])
            if a is not None and e < max_emit[slot]:
                x, mine = carry[slot].double(), int(rows[slot, e])
                pick = int(x.argmax())
                rejections.append((a["req"].req_id, len(a["generated"]) + e,
                                   mine, pick, (x[pick] - x[mine]).item(),
                                   x.abs().max().item()))
        return packed

    with M.batch_invariant():
        t0 = time.perf_counter()
        res = run_paged_engine_backend(
            "chatglm-6b", 0.0, 0.0, "magnus-paged", seed=0, reduced=False,
            device="cuda", dtype=torch.float32, prefix_cache=True,
            requests=reqs, params=params, **serve)
        off_wall = time.perf_counter() - t0
        eng = res.pop("engine")
        eng.assert_drained()
        check(res["requests"] == len(reqs),
              "the f32 spec-off serve left requests")
        streams_off = [eng.generated[r.req_id] for r in reqs]
        del eng, res
        torch.cuda.empty_cache()
        E.PagedContinuousEngine._speculate = watched
        try:
            t0 = time.perf_counter()
            res = run_paged_engine_backend(
                "chatglm-6b", 0.0, 0.0, "magnus-paged", seed=0,
                reduced=False, device="cuda", dtype=torch.float32,
                prefix_cache=True, requests=reqs, params=params,
                spec_decode=True, draft_k=DRAFT_K, **serve)
            on_wall = time.perf_counter() - t0
        finally:
            E.PagedContinuousEngine._speculate = speculate
    eng = res.pop("engine")
    eng.assert_drained()
    out = {k: res[k] for k in ("requests", "spec_windows", "host_syncs",
                               "acceptance_rate", "accepted_per_dispatch",
                               "prefill_dispatches", "decode_steps",
                               "wall_s", "token_tp")}
    flips = []
    for i, r in enumerate(reqs):
        mine, want = eng.generated.get(r.req_id), streams_off[i]
        if mine != want:
            at = next((j for j, (x, y) in enumerate(zip(mine or [], want))
                       if x != y), None)
            flips.append({"request": i, "token": at,
                          "spec_off": None if at is None else want[at],
                          "spec_on": None if at is None else mine[at]})
    index = {r.req_id: i for i, r in enumerate(reqs)}
    accepted, drafted = eng.spec_accepted, eng.spec_drafted
    rounding = sum(a == b for a, b in zip(streams_off, streams32))
    log(f"spec f32 witness, batch-invariant (self-draft, "
        f"{SPEC_F32_BLOCKS} f32 blocks a pool, peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB "
        f"allocated): spec off {off_wall:.1f} s, spec on {on_wall:.1f} s "
        f"with set-up; " + json.dumps(out) + f"; {len(reqs) - len(flips)} "
        f"of {len(reqs)} streams equal the spec-off serve's; {accepted} of "
        f"{drafted} proposals accepted; differing streams at their first "
        f"differing token: {json.dumps(flips)}; rejected proposals "
        f"(request, generated token, the draft's token, the verify's, the "
        f"verify's logit gap between them, the verify's largest logit): "
        + json.dumps([(index[r], t, d, v, round(g, 7), round(sc, 3))
                      for r, t, d, v, g, sc in rejections])
        + f"; for the log only: {rounding} of {len(reqs)} batch-invariant "
        f"spec-off streams equal phase 15's f32 serve's (the default "
        f"arithmetic)")
    check(eng.graph_captures == 1 and res["host_syncs"] == eng.spec_windows,
          "the f32 spec serve's captures or host syncs")
    check(out["requests"] == len(reqs), "the f32 spec serve left requests")
    check(not flips, f"in f32, spec streams "
          f"{[f['request'] for f in flips]} differ from spec off")
    check(accepted == drafted, f"the f32 self-draft had {drafted - accepted}"
          f" of {drafted} proposals rejected (acceptance "
          f"{out['acceptance_rate']})")
    del eng, res, params
    torch.cuda.empty_cache()
    return out


def spec_phase(torch, ops, ref, cfg, reqs, streams5, shapes5, streams32,
               res5, spin, reset_counts, counts):
    """Phase 16: speculative decoding at full width, the draft-and-verify
    window as one captured graph per engine.  (a) Phase 5's serve
    through the launcher with a self-draft: exact counts, every layer-0
    draft step, verify and wave held against the plain kernels, the
    streams against phase 5's (``reqs``, ``streams5``, ``shapes5``) by
    cause, the verify's and the draft's kernel timed at their own
    inputs, the window profiled; (b) a rejecting draft through
    ``drive_paged``: counts, holds, both pools drained; (c) the f32
    witness, spec on against spec off in the batch-invariant arithmetic
    (phase 15's f32 streams ``streams32`` for the log).  Each engine
    is dropped, its pools freed, before the next is built."""
    import gc
    from repro_torch.models import model as M
    from repro_torch.workload.apps import make_shared_head_dataset
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log(f"phase 16: {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
        f"allocated before it")
    sreqs = make_shared_head_dataset(N_REQUESTS, n_apps=3,
                                     gen_length=GEN_LENGTH, seed=0)
    t0 = time.perf_counter()
    seng, sres, srec, sshapes, slaunch, splain = spec_serve(
        torch, sreqs, reset_counts, counts)
    log(f"spec serve chatglm-6b full width bf16 (self-draft, draft_k "
        f"{DRAFT_K}): {time.perf_counter() - t0:.1f} s with set-up; "
        + json.dumps(sres))
    check(sres["requests"] == N_REQUESTS and seng.draft_params is
          seng.params, f"spec serve: {sres['requests']} requests, or "
          f"not a self-draft")
    seng.assert_drained()
    spec_counts("spec serve", seng, slaunch, splain, sres)
    for r in sreqs:
        toks = seng.generated[r.req_id]
        check(len(toks) == min(r.gen_length, SERVE["max_gen"])
              and all(0 <= x < cfg.vocab_size for x in toks),
              f"spec request {r.req_id}: {len(toks)} tokens or one out "
              f"of range")
    verifies, dsteps, _ = hold_spec(torch, ops, ref, "spec serve", seng,
                                    srec, seng.spec_w)
    same, restarted, other, unexplained = compare_streams(
        sreqs, seng.generated, sshapes, reqs, streams5, shapes5)
    log(f"spec serve streams against phase 5's, bf16: {same} equal; "
        f"differ: {len(restarted)} restarted, {len(other)} with another KV "
        f"lineage than phase 5 (requests {other}), {len(unexplained)} with "
        f"phase 5's lineage, so by the verify's and the draft's own "
        f"rounding (requests {unexplained}); each must equal the f32 "
        f"witness's spec-off stream in f32 (c)")
    log(f"spec serve: {sres['token_tp']} tokens/s in {sres['wall_s']} "
        f"s (phase 5: {res5['token_tp']} in {res5['wall_s']} s); "
        f"{sres['accepted_per_dispatch']} tokens a verify row, "
        f"acceptance {sres['acceptance_rate']}")
    spec16 = {"windows": seng.spec_windows, "launches": slaunch}
    pick = lambda xs: xs[::max(1, -(-len(xs) // SPEC_TIMED))]
    t16 = {"verify": summarize(
               "paged_prefix_prefill_attention at the verify (S = W)",
               *time_prefill(torch, ops, ref, pick(verifies),
                             seng.pages["k"], seng.pages["v"], spin)),
           "draft": summarize(
               "paged_decode_attention on the self-draft's pool",
               *time_decode(torch, ops, ref, pick(dsteps),
                            seng.draft_pages["k"],
                            seng.draft_pages["v"], spin))}
    log_profiles("spec window at 32 rows", spec_profile(
        torch, seng, make_shared_head_dataset(
            SERVE["max_concurrency"], n_apps=3, gen_length=GEN_LENGTH,
            seed=1)))
    del seng, sres, srec, verifies, dsteps
    torch.cuda.empty_cache()

    bparams = M.init_params(cfg, seed=0, device="cuda",
                            dtype=torch.bfloat16)   # phase 5's weights
    breqs = make_shared_head_dataset(N_REQUESTS, n_apps=3,
                                     gen_length=GEN_LENGTH, seed=0)
    beng, bst, brec, blaunch, bplain, bwall = small_draft_serve(
        torch, cfg, bparams, breqs, reset_counts, counts)
    check(not bst["unserved"] and bst["served"] == N_REQUESTS,
          f"rejecting-draft serve: {bst['served']} served")
    beng.assert_drained()
    spec_counts("rejecting-draft serve", beng, blaunch, bplain, bst)
    check(bst["acceptance_rate"] < 1.0,
          f"the rejecting draft accepted {bst['acceptance_rate']}")
    _, bsteps, _ = hold_spec(torch, ops, ref, "rejecting-draft serve",
                             beng, brec, beng.spec_w)
    t16["small draft"] = summarize(
        "paged_decode_attention on the small draft's pool (D 64)",
        *time_decode(torch, ops, ref, pick(bsteps),
                     beng.draft_pages["k"], beng.draft_pages["v"],
                     spin))
    same = sum(beng.generated[r.req_id] == streams5[i]
               for i, r in enumerate(breqs))
    tokens = sum(len(g) for g in beng.generated.values())
    log(f"rejecting-draft serve ({beng.draft_cfg.num_layers} layers, "
        f"d_model {beng.draft_cfg.d_model}, head {beng.draft_cfg.head_dim}"
        f"): {bwall:.2f} s, {tokens / bwall:.1f} tokens/s; "
        f"{same} of {N_REQUESTS} streams equal phase 5's; both pools "
        f"drained")
    del beng, brec, bsteps, bparams
    torch.cuda.empty_cache()

    log("phase 16 kernels (mean of per-shape medians, CUDA events, ms): "
        + json.dumps({"spec_launches": spec16["launches"],
                      "spec_windows": spec16["windows"],
                      **{k: {key: (round(v, 4) if isinstance(v, float)
                                   else v) for key, v in row.items()}
                         for k, row in t16.items()}}))
    spec_f32_witness(torch, cfg, reqs, streams32)
    log(f"phase 16 peak: {torch.cuda.max_memory_allocated() / 2 ** 30:.2f}"
        f" GiB allocated")


# ---------------------------------------------------------------------------
# phase 17: kill and recover (§17), restored in place under the graph
# ---------------------------------------------------------------------------

# (a) and (c) run phase 5's schedule (9 windows; admission waves in
# windows 1 and 6, after which a snapshot refuses, as the reference's
# does with the radix cache): snapshots after windows 2 and 4, the crash
# at window 6's seam (32 requests finished in window 5, the last 16
# admitted and prefilled, none decoded), then the recovery restores
# window 4's image (32 rows in flight, 16 requests to replay) and
# snapshots after window 8 (scripts/recovery_rehearsal.py)
RECOVER_EVERY, RECOVER_CRASH, RECOVERY_EVERY = 2, 6, 4
# (b) phase 15's geometry, the app head1 under-predicted x0.25 and the
# pool shrunk by 40 blocks from window 3, so that two requests suspend
# in each of windows 3-5: a snapshot after window 3 (two images in the
# tier), the crash at window 4's first swap-out; the recovery does not
# snapshot (its run admits in most windows)
SWAP_EVERY, SWAP_CRASH, SWAP_RECOVERY_EVERY = 3, 4, 1_000
P17_DISK = 10 << 30            # free disk the phase needs: (c)'s f32
#                                snapshots take ~6.1 GB


def p17_events(FaultEvent, kind):
    """The crashed run's fault plan: (a) and (c) crash at window
    ``RECOVER_CRASH``'s window seam; (b) skews, shrinks the pool and
    crashes at window ``SWAP_CRASH``'s first swap-out."""
    if kind == "swap":
        return [FaultEvent(window=0, kind="predict_skew", app="head1",
                           factor=0.25),
                FaultEvent(window=3, kind="pool_shrink", blocks=40),
                FaultEvent(window=SWAP_CRASH, kind="crash", seam="swap")]
    return [FaultEvent(window=RECOVER_CRASH, kind="crash", seam="window")]


def crash_run(torch, cfg, params, device, dtype, ckpt, *, every, events,
              geometry, service, swap_blocks=0):
    """Phase 17's crashed process: phase 5's requests on an engine of
    ``geometry`` with ``params``, a ``FaultInjector`` over ``events``
    (its crash among them) and the NaN guard off (one readback a window,
    as in phase 5), driven by ``drive_paged`` under a ``RecoveryManager``
    that snapshots every ``every`` windows into ``ckpt``: with
    ``service`` as the launcher drives it (``magnus_service``: phase 5's
    schedule), else over the request list (as phase 15).  Returns the
    engine, the requests, the manager and the crash's (seam, window), or
    None if it did not fire."""
    from repro_torch.serving import snapshot as snaplib
    from repro_torch.serving.engine import PagedContinuousEngine, drive_paged
    from repro_torch.serving.faults import EngineCrash, FaultInjector
    from repro_torch.workload.apps import make_shared_head_dataset
    reqs = make_shared_head_dataset(N_REQUESTS, n_apps=3,
                                    gen_length=GEN_LENGTH, seed=0)
    kw = dict(device=device, dtype=dtype, faults=FaultInjector(events),
              nan_guard=False, swap_blocks=swap_blocks,
              **{k: geometry[k] for k in ("max_concurrency", "max_len",
                                          "max_gen")})
    drive = {}
    if service:
        allocator, svc, ewma, refill, backlog = magnus_service(cfg, geometry)
        engine = PagedContinuousEngine(cfg, params, allocator=allocator,
                                       prefix_cache=svc.prefix_cache,
                                       mispredict=ewma, **kw)
        for r in reqs:
            svc.on_request(r, r.arrival_time)
        todo, drive = [], {"refill": refill, "backlog": backlog}
    else:
        engine = PagedContinuousEngine(
            cfg, params, num_blocks=geometry["num_blocks"],
            block_tokens=geometry["block_tokens"], prefix_cache=True, **kw)
        todo = list(reqs)
    mgr = snaplib.RecoveryManager(ckpt, snapshot_every=every)
    crash = None
    try:
        drive_paged(engine, todo, max_steps=100_000, recovery=mgr, **drive)
    except EngineCrash as e:
        # the seam and window only: the exception's traceback holds the
        # engine, and with it its pool
        crash = (e.seam, e.window)
    mgr.close()
    return {"engine": engine, "reqs": reqs, "mgr": mgr, "crash": crash}


def recover_run(torch, cfg, params, device, dtype, ckpt, *, every,
                geometry, swap_blocks=0, warm=True, built=None):
    """``serving.snapshot.recover`` of ``ckpt`` onto a fresh engine of the
    crashed one's geometry and weight tensors, without faults (a dead
    process's plan does not survive it), its decode step captured before
    the restore (on the card): built with ``warmup=True`` (``warm``
    True), or warmed at one wave shape and its decode (``warm`` "decode",
    for modes whose waves are slow to warm at every shape).
    ``built(engine)`` runs on it before the restore.  Returns the
    recovered engine and the report."""
    from repro_torch.serving import snapshot as snaplib
    from repro_torch.serving.engine import PagedContinuousEngine

    def factory():
        engine = PagedContinuousEngine(
            cfg, params, device=device, dtype=dtype,
            num_blocks=geometry["num_blocks"],
            block_tokens=geometry["block_tokens"], prefix_cache=True,
            swap_blocks=swap_blocks, warmup=warm is True,
            **{k: geometry[k] for k in ("max_concurrency", "max_len",
                                        "max_gen")})
        if warm == "decode":
            engine.warmup(suffix_buckets=[8], batch_sizes=[1], windows=[1])
        if built is not None:
            built(engine)
        return engine

    return snaplib.recover(factory, ckpt, snapshot_every=every)


class snapshot_parts:
    """Inside the ``with`` block every engine snapshot is timed in its
    parts, on the host clock: the gather and the two readbacks
    (``readback``), the SHA-256 over its arrays (``hash``), and the rest
    of its writing (``write``: packing, meta, the npz), beside its
    blocks and file bytes; every snapshot read is timed (``reads``: the
    file loaded and its checksum verified), and ``last`` keeps the meta
    and arrays of the last one read, for the checks right after a
    restore."""

    def __init__(self):
        self.snaps, self.reads, self.last = [], [], None

    def __enter__(self):
        from repro_torch.serving import engine as E
        from repro_torch.serving import snapshot as snaplib
        self.orig = (E.PagedContinuousEngine.snapshot, snaplib.save_engine,
                     snaplib._digest, snaplib.read_snapshot)
        snap, save, digest, read = self.orig
        parts = {}

        def timed_digest(*a):
            t0 = time.perf_counter()
            out = digest(*a)
            if "t0" in parts:
                parts["hash"] = parts.get("hash", 0.0) \
                    + time.perf_counter() - t0
            return out

        def timed_save(*a, **kw):
            parts["readback"] = time.perf_counter() - parts["t0"]
            t0 = time.perf_counter()
            out = save(*a, **kw)
            parts["save"] = time.perf_counter() - t0
            return out

        def timed_snapshot(engine, path):
            blocks = sum(b != engine.null_block
                         for b in engine.allocator.refcount)
            parts.clear()
            parts["t0"] = time.perf_counter()
            out = snap(engine, path)
            total = time.perf_counter() - parts.pop("t0")
            self.snaps.append({
                "window": engine.windows, "blocks": blocks,
                "bytes": os.path.getsize(out), "total_s": total,
                "readback_s": parts["readback"], "hash_s": parts["hash"],
                "write_s": parts["save"] - parts["hash"]})
            return out

        def timed_read(path):
            t0 = time.perf_counter()
            self.last = read(path)
            self.reads.append(time.perf_counter() - t0)
            return self.last

        E.PagedContinuousEngine.snapshot = timed_snapshot
        snaplib.save_engine = timed_save
        snaplib._digest = timed_digest
        snaplib.read_snapshot = timed_read
        return self

    def __exit__(self, *exc):
        from repro_torch.serving import engine as E
        from repro_torch.serving import snapshot as snaplib
        (E.PagedContinuousEngine.snapshot, snaplib.save_engine,
         snaplib._digest, snaplib.read_snapshot) = self.orig
        self.last = None


def _bits(torch, a):
    """A host tensor's (or numpy array's) bytes as integers of its width,
    for a byte-for-byte comparison."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(a)
    t = t.cpu()
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def _addresses(engine):
    return {"logits": engine.logits.data_ptr(),
            "positions": engine.positions.data_ptr(),
            "tables": engine.tables.data_ptr(),
            "active": engine.active_mask.data_ptr(),
            **{f"pages.{k}": v.data_ptr() for k, v in engine.pages.items()}}


def p17_run(torch, ops, ref, cfg, params, dtype, ckpt, *, kind, geometry,
            every, recovery_every, service, swap_blocks, warm,
            reset_counts, counts, holds=True, spin=None):
    """One kill and recover of phase 17 on the card: ``crash_run``, the
    crashed engine dropped and its memory freed, then ``recover_run``.

    Right after the restore: the restored pool's blocks, logits rows and
    tier slots equal the file's bytes, the tier's store is pinned, and
    the tensors the decode graph captured (in the warmup, before the
    restore) are still the engine's.  After every window of the
    recovered engine, with ``holds``: its layer-0 decode steps (a
    replayed step's from the tensors the graph captured) and admission
    waves go through each paged kernel and its plain version on its
    pools as they are then (phase 6's ``hold``); with ``spin``, the
    first window's decode steps are also timed there, on the restored
    pool, as phase 6 times.  Launch counts are zeroed before the crashed
    run and again after the recovery's warmup, and the holds' launches
    are taken back.  Each wave's KV lineage is recorded across both
    engines.  Returns what the checks and the log need."""
    import gc
    from repro_torch.models import model as M
    from repro_torch.models import transformer
    from repro_torch.serving import engine as E
    from repro_torch.serving.faults import FaultEvent
    device = "cuda"
    out = {"kind": kind}
    timer = snapshot_parts()
    with timer, wave_shapes() as shapes:
        reset_counts()
        t0 = time.perf_counter()
        crashed = crash_run(torch, cfg, params, device, dtype, ckpt,
                            every=every, events=p17_events(FaultEvent, kind),
                            geometry=geometry, service=service,
                            swap_blocks=swap_blocks)
        torch.cuda.synchronize()
        out["crash_wall"] = time.perf_counter() - t0
        launches = counts("launches")
        eng = crashed["engine"]
        reqs = crashed["reqs"]
        out["crashed"] = {
            "crash": crashed["crash"], "windows": eng.windows,
            "decode_steps": eng.decode_steps,
            "waves": eng.prefill_dispatches, "host_syncs": eng.host_syncs,
            "finished": len(eng.generated), "active": eng.num_active,
            "suspended": eng.num_suspended, "swap_outs": eng.swap_outs,
            "snapshots": crashed["mgr"].snapshots_taken,
            "captures": eng.graph_captures}
        n_snaps = len(timer.snaps)
        # process death: the engine, its graph and its pool go before the
        # fresh engine allocates its own; the weights stay, shared
        del eng, crashed
        gc.collect()
        torch.cuda.empty_cache()
        out["after_death_gib"] = torch.cuda.memory_allocated() / 2 ** 30

        keeping = {"on": False}
        decoded = Recorder(
            transformer, "paged_decode_attention", cfg.num_layers,
            lambda q, kp, vp, tables, lengths, **_:
            (q.clone(), tables.clone(), lengths.clone())
            if keeping["on"] else None, snap=(0, 4))
        waves = Recorder(
            transformer, "paged_prefix_prefill_attention", cfg.num_layers,
            lambda q, ks, vs, kp, vp, tables, plens, slens:
            (q, ks, vs, tables.clone(), plens.clone(), slens.clone())
            if keeping["on"] else None)
        st = {"windows": 0, "errs": {"paged_decode_attention": [],
                                     "paged_prefix_prefill_attention": []}}
        holders = (ops.paged_decode_attention,
                   ops.paged_prefix_prefill_attention)

        def built(engine):
            torch.cuda.synchronize()
            st["built"] = time.perf_counter()
            st["engine"] = engine
            st["captures"] = engine.graph_captures
            st["graph"] = engine._decode_graph
            st["bound"] = {
                **{k: t.data_ptr() for k, t in
                   engine._decode_graph.state.items()},
                **{f"pages.{k}": v.data_ptr()
                   for k, v in engine.pages.items()}}
            decoded.kept.clear()
            waves.kept.clear()
            keeping["on"] = True
            reset_counts()

        restore = E.PagedContinuousEngine.restore

        def checked_restore(engine, path):
            restore(engine, path)
            meta, arrays = timer.last
            blocks = meta["page_blocks"]
            got = M.gather_pages(engine.pages, torch.tensor(
                blocks, device=engine.device)).cpu()
            check(torch.equal(_bits(torch, got),
                              _bits(torch, arrays["page_values"])),
                  f"{kind}: the restored pool's {len(blocks)} blocks differ "
                  f"from the file's page_values")
            del got
            check(torch.equal(_bits(torch, engine.logits),
                              _bits(torch, arrays["logits"])),
                  f"{kind}: the restored logits rows differ from the file's")
            check(_addresses(engine) == st["bound"],
                  f"{kind}: the restore moved a tensor the graph captured")
            used = meta["swap"]["used"] if meta["swap"] else []
            if used:
                store = engine.swap._store[used].movedim(0, 2)
                check(torch.equal(_bits(torch, store),
                                  _bits(torch, arrays["swap_store"])),
                      f"{kind}: the restored tier slots {used} differ from "
                      f"the file's swap_store")
                check(engine.swap._store.is_pinned(),
                      f"{kind}: the restored tier's store is not pinned")
            st["restored"] = {
                "file": os.path.basename(path), "blocks": len(blocks),
                "active": engine.num_active,
                "suspended": engine.num_suspended, "tier_slots": len(used),
                "finished": len(engine.generated),
                "decode_steps": engine.decode_steps,
                "waves": engine.prefill_dispatches,
                "tokens": sum(len(g) for g in engine.generated.values())
                + sum(len(a["generated"]) for a in engine.active if a)
                + sum(len(i["generated"])
                      for i in engine._swapped.values())}
            timer.last = None

        def held_window(engine, *a, **kw):
            replayed0 = rep.replayed_steps
            result = step_window(engine, *a, **kw)
            if engine is not st.get("engine") or not holds:
                return result
            t_hold = time.perf_counter()
            n0 = [fn.launches for fn in holders]
            if st["windows"] == 0:
                check(engine.graph_captures == st["captures"] == 1
                      and engine._decode_graph is st["graph"]
                      and rep.replayed_steps - replayed0 == result[2] > 0,
                      f"{kind}: the recovered engine's first window "
                      f"captured ({engine.graph_captures} captures) or "
                      f"ran steps eagerly")
                if spin is not None:
                    out["timed"] = summarize(
                        "paged_decode_attention on the restored pool "
                        "(phase 17, the recovered engine's first window)",
                        *time_decode(torch, ops, ref, decoded.kept,
                                     engine.pages["k"], engine.pages["v"],
                                     spin))
            K, V = engine.pages["k"][0], engine.pages["v"][0]
            for q, tables, lens in decoded.kept:
                st["errs"]["paged_decode_attention"].append(hold(
                    torch, "paged_decode_attention",
                    ops.paged_decode_attention(q, K, V, tables, lens),
                    ref.paged_decode_attention_ref(q, K, V, tables, lens)))
            for q, ks, vs, tables, pl, sl in waves.kept:
                st["errs"]["paged_prefix_prefill_attention"].append(hold(
                    torch, "paged_prefix_prefill_attention",
                    ops.paged_prefix_prefill_attention(
                        q, ks, vs, K, V, tables, pl, sl),
                    ref.paged_prefix_prefill_attention_ref(
                        q, ks, vs, K, V, tables, pl, sl)))
            decoded.kept.clear()
            waves.kept.clear()
            for fn, n in zip(holders, n0):
                fn.launches = n
            st["windows"] += 1
            st["held_s"] = st.get("held_s", 0.0) \
                + time.perf_counter() - t_hold
            return result

        with decoded, waves, replays(decoded) as rep:
            step_window = E.PagedContinuousEngine.step_window
            E.PagedContinuousEngine.restore = checked_restore
            E.PagedContinuousEngine.step_window = held_window
            try:
                eng, report = recover_run(
                    torch, cfg, params, device, dtype, ckpt,
                    every=recovery_every, geometry=geometry,
                    swap_blocks=swap_blocks, warm=warm, built=built)
                torch.cuda.synchronize()
                t_end = time.perf_counter()
            finally:
                E.PagedContinuousEngine.restore = restore
                E.PagedContinuousEngine.step_window = step_window
        st.pop("engine", None)
        st.pop("graph", None)
        for name, n in counts("launches").items():
            launches[name] += n
    eng.assert_drained()
    rs = st["restored"]
    tokens = sum(len(g) for g in eng.generated.values()) - rs["tokens"]
    # the recovered serve: from the end of the restore to the end of the
    # run, less the holds and timings made between its windows; its
    # snapshots are part of it
    wall = (t_end - st["built"] - report["restore_s"]
            - st.get("held_s", 0.0))
    out.update({
        "engine": eng, "reqs": reqs, "report": report, "restored": rs,
        "launches": launches, "plain_calls": counts("plain_calls"),
        "snaps": timer.snaps, "crash_snaps": n_snaps,
        "reads_s": timer.reads, "shapes": shapes.by_req,
        "serve_wall": wall, "tokens_per_s": tokens / wall,
        "snapshot_s": sum(x["total_s"] for x in timer.snaps[n_snaps:]),
        "replayed_steps": rep.replayed_steps,
        "holds": {k: (len(v), max((x for x, _ in v), default=None))
                  for k, v in st["errs"].items()},
        "steps": (out["crashed"]["decode_steps"]
                  + eng.decode_steps - rs["decode_steps"]),
        "waves": (out["crashed"]["waves"]
                  + eng.prefill_dispatches - rs["waves"])})
    return out


def check_p17(label, r, layers, *, sched5=None, invariant=False):
    """Phase 17's checks of one kill and recover: the crash fired where
    planned after its snapshots, every request recovered with nothing
    re-prefilled and both tiers drained, one capture (the warmup's) and
    every recovered step replayed, the kernels launched once per layer
    and step or wave of the two engines (in the ``invariant``
    arithmetic a wave's attention runs through the decode kernel) and
    no plain call, and, for a run of phase 5's schedule (``sched5``),
    the recovered engine's steps and waves equal phase 5's and its host
    syncs phase 5's plus exactly two a snapshot."""
    eng, rep, crashed = r["engine"], r["report"], r["crashed"]
    check(crashed["crash"] is not None and crashed["snapshots"] >= 1,
          f"{label}: the crash {crashed['crash']} after "
          f"{crashed['snapshots']} snapshots")
    check(rep["recovered"] == rep["journaled"] == N_REQUESTS
          and rep["replayed_reprefill_tokens"] == 0
          and rep["snapshot_used"] is not None,
          f"{label}: report " + json.dumps(
              {k: v for k, v in rep.items() if k != "stats"}))
    if eng.swap is not None:
        check(eng.swap.empty, f"{label}: the host tier is not empty")
    check(eng.graph_captures == 1
          and r["replayed_steps"] == eng.decode_steps
          - r["restored"]["decode_steps"],
          f"{label}: {eng.graph_captures} captures, "
          f"{r['replayed_steps']} replayed steps")
    want = {"paged_decode_attention": layers * r["steps"],
            "paged_prefix_prefill_attention": layers * r["waves"]}
    if invariant:
        want = {"paged_decode_attention": layers * (r["steps"] + r["waves"]),
                "paged_prefix_prefill_attention": 0}
    got = {k: r["launches"][k] for k in want}
    check(got == want and r["steps"] and r["waves"],
          f"{label}: launches {got}, predicted {want}")
    check(not any(r["plain_calls"].values()),
          f"{label}: plain calls {r['plain_calls']}")
    for req in r["reqs"]:
        toks = eng.generated.get(req.req_id)
        check(toks is not None and len(toks) == GEN_LENGTH
              and all(0 <= t < eng.cfg.vocab_size for t in toks),
              f"{label}: request {req.req_id} unfinished or out of range")
    if sched5 is not None:
        # the restored counter holds the crashed run's snapshots up to the
        # one used (all of them: the crash came after the last), and the
        # recovery adds its own
        snaps = len(r["snaps"])
        check(crashed["host_syncs"]
              == crashed["windows"] - 1 + 2 * crashed["snapshots"],
              f"{label}: the crashed run's {crashed['host_syncs']} host "
              f"syncs in {crashed['windows'] - 1} decoded windows and "
              f"{crashed['snapshots']} snapshots")
        check((eng.decode_steps, eng.prefill_dispatches)
              == (sched5["steps"], sched5["waves"])
              and eng.host_syncs == sched5["host_syncs"] + 2 * snaps,
              f"{label}: {eng.decode_steps} steps, "
              f"{eng.prefill_dispatches} waves, {eng.host_syncs} host "
              f"syncs with {snaps} snapshots; phase 5: {sched5}")


def log_p17(label, r, res5=None):
    rep, rs = r["report"], r["restored"]
    snaps = r["snaps"]
    log(f"{label}: crashed run {r['crash_wall']:.2f} s, " + json.dumps(
        r["crashed"]) + f"; {r['after_death_gib']:.2f} GiB allocated "
        f"after its death; restored {rs['file']}: " + json.dumps(
            {k: v for k, v in rs.items() if k != "file"})
        + f"; report " + json.dumps(
            {k: (round(v, 4) if isinstance(v, float) else v)
             for k, v in rep.items() if k not in ("stats", "snapshot_used")}))
    log(f"{label} snapshots (window, blocks, MB, host s: all, gather and "
        f"readback, hash, write): " + "; ".join(
            f"({s['window']}, {s['blocks']}, {s['bytes'] / 1e6:.1f}, "
            f"{s['total_s']:.3f}, {s['readback_s']:.3f}, {s['hash_s']:.3f}, "
            f"{s['write_s']:.3f})" for s in snaps)
        + f"; reads (load and checksum) {[round(x, 3) for x in r['reads_s']]}"
        f" s; restore_s {rep['restore_s']:.3f}")
    tp = (f"{r['tokens_per_s']:.1f} tokens/s in {r['serve_wall']:.2f} s, "
          f"{r['snapshot_s']:.2f} s of it in its snapshots")
    if res5 is not None:
        tp += f" (phase 5: {res5['token_tp']} in {res5['wall_s']} s)"
    log(f"{label}: recovered serve {tp}; launches {r['launches']} over "
        f"{r['steps']} steps and {r['waves']} waves; holds " + json.dumps(
            {k: [n, None if e is None else float(f"{e:.4g}")]
             for k, (n, e) in r["holds"].items()}))


def recovery_phase(torch, ops, ref, cfg, reqs5, streams5, shapes5, sched5,
                   res5, spin, reset_counts, counts):
    """Phase 17: kill and recover at full width.  (a) phase 5's requests,
    weights and geometry with the radix cache, driven as the launcher
    drives them, crashed mid-window after two snapshots and recovered
    onto an engine built with ``warmup=True``; (b) phase 15's geometry
    and pinned tier, crashed mid-swap after a snapshot that holds
    suspended images; (c) the f32 witness (TF32 off, inside
    ``batch_invariant()``, phase 16 (c)'s weights and pool): an uncrashed
    serve, then (a)'s crash and recovery, whose every stream must equal
    the uncrashed serve's.  The bf16 streams and journal mismatches are
    put down to their causes against phase 5's (``compare_streams``); a
    bf16 difference fails only where (c) differs too.  Each engine is
    dropped and its pool freed before the next is built; the snapshots
    go to a temporary directory, whose free space is checked first, and
    which the phase removes.  Returns row 1's timing on the restored
    pool."""
    import gc
    import shutil
    import tempfile
    from repro_torch.models import model as M
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-recovery-")
    try:
        free = shutil.disk_usage(tmp).free
        log(f"phase 17: {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
            f"allocated before it; snapshots in {tmp}, {free / 2 ** 30:.1f}"
            f" GiB free there")
        check(free >= P17_DISK, f"{free / 2 ** 30:.1f} GiB free in {tmp}: "
              f"phase 17's snapshots need {P17_DISK / 2 ** 30:.0f}")
        params = M.init_params(cfg, seed=0, device="cuda",
                               dtype=torch.bfloat16)   # phase 5's weights
        a = p17_run(torch, ops, ref, cfg, params, torch.bfloat16,
                    os.path.join(tmp, "a"), kind="window", geometry=SERVE,
                    every=RECOVER_EVERY, recovery_every=RECOVERY_EVERY,
                    service=True, swap_blocks=0, warm=True,
                    reset_counts=reset_counts, counts=counts, spin=spin)
        check_p17("phase 17 (a)", a, cfg.num_layers, sched5=sched5)
        log_p17("phase 17 (a)", a, res5)
        same, restarted, other, unexplained = compare_streams(
            a["reqs"], a["engine"].generated, a["shapes"], reqs5, streams5,
            shapes5)
        differ16 = restarted + other + unexplained
        log(f"phase 17 (a) streams against phase 5's, bf16: {same} equal; "
            f"differ: {restarted} restarted, {other} with another KV "
            f"lineage than phase 5, {unexplained} with phase 5's lineage")
        timed = a.pop("timed")
        mism16 = a["report"]["journal_mismatches"]
        del a
        shutil.rmtree(os.path.join(tmp, "a"))
        gc.collect()
        torch.cuda.empty_cache()

        b = p17_run(torch, ops, ref, cfg, params, torch.bfloat16,
                    os.path.join(tmp, "b"), kind="swap", geometry=CHAOS,
                    every=SWAP_EVERY, recovery_every=SWAP_RECOVERY_EVERY,
                    service=False, swap_blocks=CHAOS_SWAP_BLOCKS,
                    warm="decode", reset_counts=reset_counts, counts=counts)
        check_p17("phase 17 (b)", b, cfg.num_layers)
        check(b["crashed"]["crash"][0] == "swap"
              and b["restored"]["suspended"] >= 1
              and b["restored"]["tier_slots"] >= 1
              and b["engine"].swap_ins >= b["restored"]["suspended"],
              f"phase 17 (b): crash {b['crashed']['crash']}, restored "
              f"{b['restored']}, {b['engine'].swap_ins} resumes")
        log_p17("phase 17 (b)", b)
        del b, params
        shutil.rmtree(os.path.join(tmp, "b"))
        gc.collect()
        torch.cuda.empty_cache()

        c = p17_f32_witness(torch, ops, ref, cfg, os.path.join(tmp, "c"),
                            reset_counts, counts)
        both = [i for i in differ16 if i in c["differ"]]
        log(f"phase 17: bf16 journal mismatches {mism16}; bf16 streams "
            f"differing from phase 5's {differ16}, of them also differing "
            f"in the f32 witness {both}")
        check(not both, f"phase 17: streams {both} differ in bf16 and in "
              f"the f32 witness")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 17 peak: {torch.cuda.max_memory_allocated() / 2 ** 30:.2f}"
        f" GiB allocated")
    return timed


def p17_f32_witness(torch, ops, ref, cfg, ckpt, reset_counts, counts):
    """Phase 17 (c): in f32 (TF32 off) inside ``batch_invariant()``, on
    phase 16 (c)'s f32 weights and pool, an uncrashed serve of phase 5's
    requests as the launcher drives them, then (a)'s crash and
    recovery, whose every stream must equal the uncrashed serve's, with
    no journal mismatch and nothing re-prefilled."""
    import gc
    from repro_torch.models import model as M
    from repro_torch.serving.engine import PagedContinuousEngine, drive_paged
    from repro_torch.workload.apps import make_shared_head_dataset
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is on for f32 GEMMs")
    geometry = dict(SERVE, num_blocks=SPEC_F32_BLOCKS)
    params = M.init_params(cfg, seed=0, device="cuda", dtype=torch.float32)
    with M.batch_invariant():
        reqs = make_shared_head_dataset(N_REQUESTS, n_apps=3,
                                        gen_length=GEN_LENGTH, seed=0)
        allocator, svc, ewma, refill, backlog = magnus_service(cfg, geometry)
        eng = PagedContinuousEngine(
            cfg, params, device="cuda", dtype=torch.float32,
            allocator=allocator, prefix_cache=svc.prefix_cache,
            mispredict=ewma, **{k: geometry[k] for k in (
                "max_concurrency", "max_len", "max_gen")})
        for r in reqs:
            svc.on_request(r, r.arrival_time)
        t0 = time.perf_counter()
        drive_paged(eng, [], max_steps=100_000, refill=refill,
                    backlog=backlog)
        wall = time.perf_counter() - t0
        eng.assert_drained()
        want = [eng.generated[r.req_id] for r in reqs]
        sched = {"steps": eng.decode_steps, "waves": eng.prefill_dispatches,
                 "host_syncs": eng.host_syncs}
        del eng, allocator, svc
        gc.collect()
        torch.cuda.empty_cache()
        c = p17_run(torch, ops, ref, cfg, params, torch.float32, ckpt,
                    kind="window", geometry=geometry, every=RECOVER_EVERY,
                    recovery_every=RECOVERY_EVERY, service=True,
                    swap_blocks=0, warm="decode", reset_counts=reset_counts,
                    counts=counts, holds=False)
    check_p17("phase 17 (c)", c, cfg.num_layers, sched5=sched,
              invariant=True)
    log_p17("phase 17 (c)", c)
    got = [c["engine"].generated[r.req_id] for r in c["reqs"]]
    differ = [i for i, (x, y) in enumerate(zip(got, want)) if x != y]
    rep = c["report"]
    log(f"phase 17 (c), f32 witness: uncrashed serve {wall:.2f} s, "
        f"{sched}; {N_REQUESTS - len(differ)} of {N_REQUESTS} recovered "
        f"streams equal it (differing: {differ}); journal mismatches "
        f"{rep['journal_mismatches']}, confirmed "
        f"{rep['journal_confirmed']}")
    check(not differ and rep["journal_mismatches"] == 0
          and rep["replayed_reprefill_tokens"] == 0,
          f"phase 17 (c): recovered f32 streams {differ} differ from the "
          f"uncrashed serve's, {rep['journal_mismatches']} journal "
          f"mismatches")
    del c, params
    gc.collect()
    torch.cuda.empty_cache()
    return {"differ": differ}


# ---------------------------------------------------------------------------
# phase 18: the MoE family (olmoe-1b-7b) on the paged main path
# ---------------------------------------------------------------------------

# olmoe-1b-7b at full width (16 layers, d_model 2048, 16 heads of 128, 64
# experts top 8 of width 1024, capacity factor 1.25) on phase 5's
# geometry, requests and radix cache.  Its schedule, from
# scripts/moe_rehearsal.py (the same serve of the reduced() config on the
# CPU): decode steps, admission waves and host syncs (one a window)
MOE_ARCH = "olmoe-1b-7b"
MOE_SCHEDULE = dict(decode_steps=128, waves=5, host_syncs=9)
MOE_HOLD_EVERY = 16            # the FFN hold: every 16th step, every wave
MOE_FREE_BEFORE = 2 << 30      # allocated before the phase: chatglm-6b's
#                                weights (12.4 GB) must be gone



def moe_dispatch(torch, p, x, m, group_size):
    """Phase 18's plain form of the reference's routing over x [B, S, d]
    (flattened row-major into groups of ``moe._num_groups``), computed on
    its own: the f32 router logits, top-k and renormalised gates, then
    each group's drop set by walking its tokens in order and each
    token's k experts in rank order, an assignment kept while its expert
    holds fewer than ``cap``.  Returns (kept: per expert the (token,
    rank) pairs it computes, renormalised gates [T, K], dropped share,
    groups, cap)."""
    import math
    b, s, d = x.shape
    t, e, k = b * s, m.num_experts, m.top_k
    g = max(1, math.ceil(t / group_size))
    while t % g:
        g += 1
    cap = max(1, math.ceil(t // g * k / e * m.capacity_factor))
    probs = torch.softmax(x.reshape(t, d).float() @ p["router"].float(), -1)
    gates, idx = torch.topk(probs, k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    ids = idx.tolist()
    kept = [[] for _ in range(e)]
    dropped = 0
    for group in range(g):
        load = [0] * e
        for i in range(group * (t // g), (group + 1) * (t // g)):
            for j, ex in enumerate(ids[i]):
                if load[ex] < cap:
                    load[ex] += 1
                    kept[ex].append((i, j))
                else:
                    dropped += 1
    return kept, gates, dropped / (t * k), g, cap


def moe_plain(torch, p, x, m, group_size):
    """The MoE FFN of x by a per-(token, expert) plain form: for each
    token and each of its kept experts (``moe_dispatch``), gate x
    SwiGLU_e(x_token), the gate rounded to bf16 as the reference's
    combine weights are; the kept rows of one expert go through its
    weights together (row by row the same products)."""
    import torch.nn.functional as F
    b, s, d = x.shape
    kept, gates, *_ = moe_dispatch(torch, p, x, m, group_size)
    gates = gates.to(torch.bfloat16).to(x.dtype)
    xt = x.reshape(b * s, d)
    y = torch.zeros_like(xt)
    for ex, pairs in enumerate(kept):
        if not pairs:
            continue
        rows = torch.tensor([i for i, _ in pairs], device=x.device)
        ranks = torch.tensor([j for _, j in pairs], device=x.device)
        xe = xt[rows]
        h = F.silu(xe @ p["gate"][ex]) * (xe @ p["up"][ex])
        y.index_add_(0, rows, (h @ p["down"][ex]) * gates[rows, ranks, None])
    return y.reshape(b, s, d)


def hold_moe(torch, moe, ps, x, m, group_size, label):
    """``moe.moe_forward`` on a served layer-0 FFN input against
    ``moe_plain``: in bf16 as served (5e-2 of scale), then in f32 with
    TF32 off on the same input and the same layer's weights in f32
    (2e-4); ``ps`` maps each dtype to the layer's weights in it.  Returns
    the two errors relative to scale."""
    out = []
    for dtype, tol in ((torch.bfloat16, 5e-2), (torch.float32, 2e-4)):
        pd, xd = ps[dtype], x.to(dtype)
        got = moe.moe_forward(pd, xd, m, group_size=group_size)[0].float()
        want = moe_plain(torch, pd, xd, m, group_size).float()
        scale = max(1.0, want.abs().max().item())
        err = (got - want).abs().max().item() / scale
        check(torch.isfinite(got).all().item(), f"{label}: non-finite FFN")
        check(err <= tol, f"{label} {dtype}: the MoE FFN is {err:.3e} of "
              f"scale {scale:.1f} from the per-token plain form (tol {tol})")
        out.append(err)
    return out


def moe_phase(torch, ops, ref, transformer, res5, spin, reset_counts,
              counts):
    """Phase 18: olmoe-1b-7b served at full width in bf16 through
    ``run_paged_engine_backend`` (``magnus-paged``, the radix cache,
    phase 5's geometry and requests), its weights drawn on the card from
    seed 0 after chatglm-6b's are gone.  Checks: every request finishes,
    the pool drains, the prefix cache hits; decode steps, waves and host
    syncs as ``MOE_SCHEDULE`` (the CPU rehearsal) predicts, the decode
    kernel launched 16 times a step and prefix prefill 16 times a wave,
    one capture and replays for every later step; every step's and
    wave's layer-0 attention held against the plain kernels; layer 0's
    FFN at every ``MOE_HOLD_EVERY``-th step, every wave and 64 served
    steps stacked into one batch of 8 groups held against the per-token
    plain form in bf16 and f32.  Logs the dropped share of every step
    and wave at layer 0, the serve's tokens/s beside phase 5's, the
    graphed and eager decode windows (held bit for bit, pools included)
    beside a step's bound, and rows 1-2 timed at olmoe's inputs.
    Returns those timings and the serve's launches."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import run_paged_engine_backend
    from repro_torch.models import moe
    from repro_torch.workload.apps import make_shared_head_dataset
    from repro_torch.workload.tokenizer import encode
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.backends.cuda.matmul.allow_tf32 = False
    before = torch.cuda.memory_allocated()
    log(f"phase 18: {before / 2 ** 30:.2f} GiB allocated before it")
    check(before < MOE_FREE_BEFORE, "chatglm-6b's weights were not "
          "released before phase 18")
    mcfg = get_config(MOE_ARCH)
    reqs = make_shared_head_dataset(N_REQUESTS, n_apps=3,
                                    gen_length=GEN_LENGTH, seed=0)
    top = max(max(encode(f"{r.instruction} {r.user_input}", mcfg.vocab_size))
              for r in reqs)
    check(top < mcfg.vocab_size, f"prompt id {top} >= {mcfg.vocab_size}")
    layers = mcfg.num_layers
    decoded, waves = paged_recorders(transformer, layers)
    ffn = Recorder(transformer, "moe_forward", layers,
                   lambda p, x, m, **_: x.clone(), snap=(1,))
    t0 = time.perf_counter()
    with decoded, waves, ffn, replays(decoded, ffn) as windows:
        reset_counts()
        res = run_paged_engine_backend(
            MOE_ARCH, 0.0, 0.0, "magnus-paged", seed=0, reduced=False,
            device="cuda", dtype=torch.bfloat16, prefix_cache=True,
            requests=reqs, **SERVE)
        launches = counts("launches")
    plain_calls = counts("plain_calls")
    engine = res.pop("engine")
    cfg = engine.cfg
    log(f"serve {MOE_ARCH} full width bf16: {time.perf_counter() - t0:.1f}"
        f" s with set-up; " + json.dumps(res))
    log(f"phase 18 serve kernel launches {launches}, plain calls "
        f"{plain_calls}, {windows.windows} decode windows, "
        f"{engine.graph_captures} capture(s) of the decode step")
    windows.log("phase 18 serve", engine.decode_steps)
    gib = 2 ** 30
    log(f"phase 18 after the serve: {torch.cuda.memory_allocated() / gib:.2f}"
        f" GiB allocated, peak so far (the weights' draw included) "
        f"{torch.cuda.max_memory_allocated() / gib:.2f}")
    check(cfg.num_layers == 16 and cfg.d_model == 2048
          and cfg.moe.num_experts == 64 and cfg.moe.top_k == 8,
          f"phase 18 did not serve {MOE_ARCH} at full width")
    check(res["requests"] == N_REQUESTS,
          f"phase 18: {res['requests']} of {N_REQUESTS} requests finished")
    engine.assert_drained()
    check(res["prefix_hits"] > 0, "phase 18: the prefix cache never hit")
    sched = {"decode_steps": engine.decode_steps,
             "waves": engine.prefill_dispatches,
             "host_syncs": res["host_syncs"]}
    check(sched == MOE_SCHEDULE, f"phase 18 schedule {sched}, the CPU "
          f"rehearsal predicted {MOE_SCHEDULE}")
    check(launches["paged_decode_attention"] == layers * sched["decode_steps"]
          and launches["paged_prefix_prefill_attention"]
          == layers * sched["waves"],
          f"phase 18 launches {launches} against {sched}")
    check(not any(plain_calls.values()),
          f"plain versions ran in phase 18: {plain_calls}")
    check(res["host_syncs"] == windows.windows,
          f"phase 18: {res['host_syncs']} host syncs in {windows.windows} "
          f"windows")
    check(engine.graph_captures == 1
          and windows.replayed_steps == engine.decode_steps - 1,
          f"phase 18: {engine.graph_captures} captures, "
          f"{windows.replayed_steps} replayed of {engine.decode_steps}")
    for r in reqs:
        toks = engine.generated[r.req_id]
        check(len(toks) == min(r.gen_length, SERVE["max_gen"])
              and all(0 <= x < cfg.vocab_size for x in toks),
              f"phase 18 request {r.req_id}: {len(toks)} tokens or one out "
              f"of range")
    check(torch.isfinite(engine.logits.float()).all().item(),
          "phase 18: non-finite logits after serving")
    check(len(decoded.kept) == sched["decode_steps"]
          and len(waves.kept) == sched["waves"]
          and len(ffn.kept) == sched["decode_steps"] + sched["waves"],
          f"phase 18 recorded {len(decoded.kept)} steps, {len(waves.kept)}"
          f" waves, {len(ffn.kept)} FFN inputs")

    # layer 0: attention held for every step and wave, the FFN against
    # its plain form, the dropped share of every step and wave
    K, V = engine.pages["k"], engine.pages["v"]
    for q, tables, lens in decoded.kept:
        hold(torch, "paged_decode_attention (phase 18)",
             ops.paged_decode_attention(q, K[0], V[0], tables, lens),
             ref.paged_decode_attention_ref(q, K[0], V[0], tables, lens))
    for q, ks, vs, tables, pl, sl in waves.kept:
        hold(torch, "paged_prefix_prefill_attention (phase 18)",
             ops.paged_prefix_prefill_attention(q, ks, vs, K[0], V[0],
                                                tables, pl, sl),
             ref.paged_prefix_prefill_attention_ref(q, ks, vs, K[0], V[0],
                                                    tables, pl, sl))
    log(f"phase 18: layer-0 attention of {len(decoded.kept)} steps and "
        f"{len(waves.kept)} waves held against the plain kernels")
    p0 = {k: v[0] for k, v in engine.params["blocks"]["moe"].items()}
    ps = {torch.bfloat16: p0, torch.float32: {
        k: v.float() for k, v in p0.items()}}
    gs = cfg.moe_group_size
    drops = {"decode": [], "wave": []}
    errs = {"decode": [], "wave": []}
    step = 0
    for x in ffn.kept:
        kind = "decode" if x.shape[1] == 1 else "wave"
        _, _, share, g, cap = moe_dispatch(torch, p0, x, cfg.moe, gs)
        drops[kind].append((round(share, 4), tuple(x.shape[:2]), g, cap))
        if kind == "wave" or step % MOE_HOLD_EVERY == 0:
            errs[kind].append(hold_moe(torch, moe, ps, x, cfg.moe, gs,
                                       f"phase 18 {kind} {len(errs[kind])}"))
        step += kind == "decode"
    # served waves are single groups (T <= 256): the groups' layout is
    # held on the served decode steps' inputs, 64 stacked as one batch
    # [32, 64] (T = 2048: 8 groups of 256, cap 40)
    steps = [x for x in ffn.kept if x.shape[1] == 1]
    if len(steps) >= 64:
        x = torch.cat(steps[:64], dim=1)
        _, _, share, g, cap = moe_dispatch(torch, p0, x, cfg.moe, gs)
        errs["wave"].append(hold_moe(torch, moe, ps, x, cfg.moe, gs,
                                     "phase 18 stacked steps"))
        drops["stacked"] = (round(share, 4), tuple(x.shape[:2]), g, cap)
    shares = [d[0] for d in drops["decode"]]
    layout = sorted({(g, c) for *_, g, c in drops["decode"]})
    log(f"phase 18 layer-0 dropped share of assignments: decode steps "
        f"(T 32, groups, cap {layout})"
        f" min {min(shares)} mean {sum(shares) / len(shares):.4f} max "
        f"{max(shares)}, each {shares}; waves (share, [rows, bucket], "
        f"groups, cap) {drops['wave']}; 64 steps stacked as one batch "
        f"{drops.get('stacked')}")
    check("stacked" in drops, "phase 18: fewer than 64 decode steps to "
          "stack into a batch of several groups")
    log(f"phase 18 FFN held against the per-token plain form (err of "
        f"scale, bf16 and f32): {len(errs['decode'])} decode steps "
        f"max {[max(e[i] for e in errs['decode']) for i in (0, 1)]}, "
        f"{len(errs['wave'])} waves and the stacked steps max "
        f"{[max(e[i] for e in errs['wave']) for i in (0, 1)]}")

    # a step's bound: every weight but the embedding read once
    weights = sum(t.numel() * t.element_size()
                  for k, v in engine.params.items() if k != "embed"
                  for t in _leaves(v))
    log(f"phase 18 decode step bound: {weights / 1e9:.2f} GB of weights "
        f"at 3.35 TB/s = {weights / HBM_BYTES_PER_S * 1e3:.2f} ms")
    log(f"phase 18 serve: {res['token_tp']} tokens/s in {res['wall_s']} s "
        f"(phase 5 chatglm-6b: {res5['token_tp']} in {res5['wall_s']} s)")
    log_profiles(f"{MOE_ARCH} decode step at 32 rows", profile_window(
        torch, engine, make_shared_head_dataset(
            SERVE["max_concurrency"], n_apps=3, gen_length=GEN_LENGTH,
            seed=1), eager=True, pools=True))

    # rows 1-2 at olmoe's own inputs: a sample of the steps, every wave
    sample = decoded.kept[::max(1, len(decoded.kept) // SPEC_TIMED)]
    t18 = {"paged_decode_attention": summarize(
               "paged_decode_attention (phase 18)", *time_decode(
                   torch, ops, ref, sample, K, V, spin)),
           "paged_prefix_prefill_attention": summarize(
               "paged_prefix_prefill_attention (phase 18)", *time_prefill(
                   torch, ops, ref, waves.kept, K, V, spin))}
    log(f"phase 18 peak: {torch.cuda.max_memory_allocated() / 2 ** 30:.2f}"
        f" GiB allocated")
    del engine, K, V, p0, ps, decoded, waves, ffn, windows
    gc.collect()
    torch.cuda.empty_cache()
    return t18, launches


# ---------------------------------------------------------------------------
# phases 11, 19-21: what every padded serve of phase 7's requests checks
# ---------------------------------------------------------------------------

def check_padded_serve(label, cfg, res, results, targets):
    """What every padded serve must show: every request served once with
    its generation length, every batch G(B) iterations, one readback a
    power-of-two window, and the schedule the CPU rehearsal predicted.
    Returns the decode steps."""
    check(res["requests"] == len(targets),
          f"{label}: {res['requests']} of {len(targets)} requests")
    check(sorted(rid for r in results for rid in r.generated)
          == sorted(targets), f"{label}: the batches did not serve each "
          f"request once")
    for r in results:
        check(r.iterations == max(targets[i] for i in r.generated),
              f"{label}: a batch ran {r.iterations} iterations, not its "
              f"G(B)")
        for rid, toks in r.generated.items():
            check(len(toks) == targets[rid]
                  and all(0 <= x < cfg.vocab_size for x in toks),
                  f"{label} request {rid}: {len(toks)} of {targets[rid]} "
                  f"tokens or one out of range")
    steps = sum(r.iterations for r in results)
    check(res["host_syncs"] == sum(bin(r.iterations).count("1")
                                   for r in results),
          f"{label}: host syncs {res['host_syncs']}: not one a window")
    return steps


def padded_schedule(res, engine, results):
    return {"batches": len(results),
            "decode_steps": sum(r.iterations for r in results),
            "host_syncs": res["host_syncs"],
            "captures": engine.graph_captures,
            "wma_total": res["wma_total"],
            "shapes": sorted([r.batch_size, r.batch_length, r.iterations]
                             for r in results)}


def phase7_requests(vocab_size):
    """Phase 7's 64 Poisson requests, their generation targets, and a
    check that every prompt id lies inside the vocabulary."""
    from repro_torch.workload.generator import poisson_workload
    from repro_torch.workload.tokenizer import encode
    reqs = poisson_workload(8, 60, seed=0, max_len=DENSE_MAX_LEN,
                            max_gen=DENSE_MAX_GEN)[:DENSE_N_REQUESTS]
    targets = {r.req_id: min(r.gen_length, DENSE_MAX_GEN) for r in reqs}
    top = max(max(encode(f"{r.instruction} {r.user_input}", vocab_size))
              for r in reqs)
    check(top < vocab_size, f"prompt id {top} >= {vocab_size}")
    return reqs, targets


# ---------------------------------------------------------------------------
# phase 19: the hybrid family (hymba-1.5b) on the padded path
# ---------------------------------------------------------------------------

# hymba-1.5b (32 layers, d_model 1600, 25 query heads over 5 KV heads of
# 64 beside 25 SSM heads of 64 with d_state 16, a 2,048-token sliding
# window) on phase 7's requests.  Its schedule, from
# scripts/hybrid_rehearsal.py (the batcher on the full config's memory
# model at an H100 80GB's memory, the reduced model served on the CPU):
# batches, decode steps, host syncs (popcount G(B) a batch), captures (a
# batch of at least MIN_GRAPH_STEPS steps), the WMA total and each
# batch's [size, length, G(B)]
HYBRID_ARCH = "hymba-1.5b"
HYBRID_SCHEDULE = dict(
    batches=9, decode_steps=576, host_syncs=9, captures=9, wma_total=28703,
    shapes=[[1, 256, 64], [1, 256, 64], [3, 256, 64], [4, 256, 64],
            [5, 256, 64], [6, 256, 64], [11, 256, 64], [13, 256, 64],
            [20, 256, 64]])
HYBRID_FREE_BEFORE = 2 << 30   # allocated before the phase: olmoe-1b-7b's
#                                weights (13.85 GB) must be gone
# (b): two prompts of a 4,096-token prefill, where the window binds in
# every layer; decoded on the engines' cache (no window at decode) and
# on the ring of the window (decode_cache_len's), 8 steps each
HYBRID_LONG = (4096, 3000)
HYBRID_CACHES = (8192, 2048)
HYBRID_LONG_STEPS = 8


def padded_step_bound(engine, reqs, bl, steps):
    """A padded decode step's least time at the profiled batch: every
    weight but the embedding read once (every expert's too: the capacity
    dispatch computes them all), the recurrent state (f32) read and
    written where the model has one, and the cache entries (K/V, or
    MLA's latents) of the window's mean length, the vlm family's patch
    prefix included, read once, at 3.35 TB/s.  Returns (ms, weights GB,
    state GB, cache GB)."""
    import math
    from repro_torch.models.transformer import cache_struct
    cfg = engine.cfg
    weights = sum(t.numel() * t.element_size()
                  for k, v in engine.params.items() if k != "embed"
                  for t in _leaves(v))
    shapes, _ = cache_struct(cfg, len(reqs), 1)
    state = 2 * sum(math.prod(shape) * 4 for shape, _ in
                    shapes.get("ssm", ()))
    prefix = cfg.num_patches if cfg.family == "vlm" else 0
    tokens = sum(min(r.length, bl) + prefix + steps / 2 for r in reqs)
    kv = tokens * cfg.kv_bytes_per_token(2)
    total = weights + state + kv
    return total / HBM_BYTES_PER_S * 1e3, weights / 1e9, state / 1e9, kv / 1e9


def hybrid_long_window(torch, ops, ref, fops, fref, sops, sref, ssm_module,
                       transformer, engine):
    """Phase 19 (b): two rows of hymba-1.5b at S = 4,096 (lengths
    ``HYBRID_LONG``), prefilled so that the 2,048-token window binds in
    every layer: layer 0's flash call (window mode, whole K/V tiles left
    of the window skipped) held against its plain version at 5e-2 of
    scale, and its SSD scan (32 chunks of 128, N 16) at 2e-4 in f32.
    Then the same prompts on two caches, each decoding
    ``HYBRID_LONG_STEPS`` steps with every step's layer-0 decode
    attention held against the plain version: the engines' cache
    (``HYBRID_CACHES[0]`` slots, every cached key read at decode) and the
    ring of the window (``HYBRID_CACHES[1]``, as the reference's
    ``decode_cache_len`` gives, where the new K/V overwrites the oldest
    slot).  Returns (the layer-0 flash call, the layer-0 scan call)."""
    from repro_torch.models import model as M
    cfg, params, dtype = engine.cfg, engine.params, engine.dtype
    s, layers, window = max(HYBRID_LONG), cfg.num_layers, cfg.sliding_window
    gen = torch.Generator(device="cuda").manual_seed(5)
    tokens = torch.randint(3, cfg.vocab_size, (len(HYBRID_LONG), s),
                           generator=gen, device="cuda", dtype=torch.int32)
    lengths = torch.tensor(HYBRID_LONG, dtype=torch.int32, device="cuda")
    flash = Recorder(transformer, "gqa_prefill_attention", layers,
                     lambda q, k, v, **kw: (q, k, v, kw))
    scan = Recorder(ssm_module, "ssd_scan", layers)
    streams = {}
    for cache_len in HYBRID_CACHES:
        dec = Recorder(transformer, "gqa_decode_attention", layers,
                       lambda q, kc, vc, lens: (q[:, 0].clone(), kc.clone(),
                                                vc.clone(), lens.clone()))
        t0 = time.perf_counter()
        with flash, scan:
            logits, cache = M.prefill(
                params, cfg, {"tokens": tokens, "lengths": lengths},
                act_dtype=dtype, cache_len=cache_len)
        check(cache["kv"][0].shape[2] == cache_len,
              f"phase 19 (b): a KV cache of {cache['kv'][0].shape[2]} "
              f"slots, not {cache_len}")
        with dec:
            logits, cache, positions, toks = M.decode_multi(
                params, cfg, cache, {"logits": logits,
                                     "positions": lengths.clone()},
                num_steps=HYBRID_LONG_STEPS, act_dtype=dtype)
        toks = toks.cpu()
        wall = time.perf_counter() - t0
        check(len(dec.kept) == HYBRID_LONG_STEPS,
              f"phase 19 (b): {len(dec.kept)} decode steps recorded")
        errs = []
        for i, (q, kc, vc, lens) in enumerate(dec.kept):
            want = torch.clamp(lengths + i + 1, max=cache_len)
            check(torch.equal(lens, want.to(lens.dtype)),
                  f"phase 19 (b) cache {cache_len} step {i}: lengths "
                  f"{lens.tolist()}, not {want.tolist()}")
            errs.append(hold(torch, f"decode_attention (phase 19 (b), "
                             f"cache {cache_len})",
                             ops.decode_attention(q, kc, vc, lens),
                             ref.decode_attention_ref(q, kc, vc, lens)))
        check(torch.isfinite(logits.float()).all().item(),
              f"phase 19 (b) cache {cache_len}: non-finite logits")
        streams[cache_len] = (toks, logits.float())
        kind = "the ring" if cache_len < s else "the engines' cache"
        slots = [[(p + i) % cache_len for i in (0, HYBRID_LONG_STEPS - 1)]
                 for p in HYBRID_LONG]
        log(f"phase 19 (b) {kind}, {cache_len} slots: prefill of "
            f"{list(HYBRID_LONG)} tokens and {HYBRID_LONG_STEPS} decode "
            f"steps in {wall:.2f} s, writing slots {slots} (first and last "
            f"of each row); every step's layer-0 decode attention held "
            f"(max abs err {max(e for e, _ in errs):.3e} at scale up to "
            f"{max(sc for _, sc in errs):.1f})")
        del cache, dec
    check(len(flash.kept) == len(scan.kept) == len(HYBRID_CACHES),
          f"phase 19 (b): kept {len(flash.kept)} flash and "
          f"{len(scan.kept)} scan calls of layer 0")
    q, k, v, kw = flash.kept[0]
    check(kw.get("window") == window and q.shape[1] == s
          and (q.shape[2], k.shape[2], q.shape[3]) == (25, 5, 64),
          f"phase 19 (b): layer 0's flash call {tuple(q.shape)} "
          f"{tuple(k.shape)} {kw}")
    err, scale = hold(torch, "flash_attention (phase 19 (b))",
                      fops.flash_attention(q, k, v, causal=True,
                                           window=window),
                      fref.flash_attention_ref(q, k, v, causal=True,
                                               window=window))
    x, dt, a, b, c, chunk = scan.kept[0]
    check(x.dtype == torch.float32 and b.shape[-1] == 16
          and -(-x.shape[1] // chunk) == 32,
          f"phase 19 (b): the scan's input {tuple(x.shape)} N "
          f"{b.shape[-1]} chunk {chunk}")
    got = sops.ssd_scan(x, dt, a, b, c, chunk)
    serr, sscale = scan_err(got, sref.ssd_chunked_ref(x, dt, a, b, c, chunk))
    check(all(torch.isfinite(t).all().item() for t in got),
          "phase 19 (b): the scan is non-finite")
    check(serr <= SCAN_TOL * max(1.0, sscale),
          f"phase 19 (b): scan err {serr} at scale {sscale}")
    (t_eng, l_eng), (t_ring, l_ring) = (streams[c] for c in HYBRID_CACHES)
    log(f"phase 19 (b) layer 0 at S {s}, window {window}: flash held (max "
        f"abs err {err:.3e} at scale {scale:.1f}), the scan ({x.shape[1]} "
        f"tokens, 32 chunks, N 16) held in f32 ({serr:.3e} at scale "
        f"{sscale:.1f}, tol {SCAN_TOL} of scale); the engines' cache and "
        f"the ring after {HYBRID_LONG_STEPS} steps: tokens equal in "
        f"{int((t_eng == t_ring).sum())} of {t_eng.numel()}, logits apart "
        f"by up to {(l_eng - l_ring).abs().max().item():.3f} at scale "
        f"{l_eng.abs().max().item():.1f} (the reference's semantics: "
        f"decode reads every cached key, the ring only the window)")
    return (q, k, v), (x, dt, a, b, c, chunk)


def hybrid_phase(torch, ops, ref, fops, fref, sops, sref, ssm_module,
                 transformer, hbm, spin, others, reset_counts, counts):
    """Phase 19: hymba-1.5b served at full width in bf16 through
    ``run_engine_backend`` (``magnus``, the padded ``BatchEngine``) on
    phase 7's requests, its weights drawn on the card from seed 0 once
    olmoe-1b-7b's are gone.  (a) Checks: every request gets its
    generation length and every batch G(B) iterations; batches, steps,
    host syncs, captures, the WMA total and the batches' shapes as
    ``HYBRID_SCHEDULE`` (the CPU rehearsal) predicts; flash and the scan
    launched once a layer and batch, dense decode once a layer and step,
    nothing else and no plain version; one capture a batch and replays
    after it; every batch's layer-0 flash call (window 2,048) and a
    sample of decode steps (replayed ones included) held against the
    plain kernels, the scans in (c); graphed against eager on the
    largest batch (held bit for bit, all four cache leaves), profiled
    beside the step's bound.  (b) :func:`hybrid_long_window`.  (c) The
    kernels timed at hymba's inputs as phase 6 times them.  (d)
    tokens/s and wall s beside ``others`` (label -> the "token_tp" and
    "wall_s" of phases 7 and 11 in the same run), the peak allocation.
    Returns (the timings, the serve's launches)."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import run_engine_backend
    from repro_torch.models.transformer import d_inner
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    log(f"phase 19: {before / 2 ** 30:.2f} GiB allocated before it; "
        f"hbm_bytes {hbm}")
    check(before < HYBRID_FREE_BEFORE, "olmoe-1b-7b's weights were not "
          "released before phase 19")
    hcfg = get_config(HYBRID_ARCH)
    reqs, targets = phase7_requests(hcfg.vocab_size)
    layers, window = hcfg.num_layers, hcfg.sliding_window
    prefills, decodes = dense_recorders(transformer, layers, window=window)
    scans = Recorder(ssm_module, "ssd_scan", layers)
    t_phase = t0 = time.perf_counter()
    with prefills, decodes, scans, replays(decodes) as rep:
        reset_counts()
        res = run_engine_backend(
            HYBRID_ARCH, 0.0, 0.0, "magnus", seed=0, reduced=False,
            device="cuda", dtype=torch.bfloat16, hbm_bytes=hbm,
            max_len=DENSE_MAX_LEN, max_gen=DENSE_MAX_GEN, requests=reqs)
        launches = counts("launches")
    plain = counts("plain_calls")
    engine, results = res.pop("engine"), res.pop("results")
    cfg = engine.cfg
    log(f"hybrid padded serve {HYBRID_ARCH} full width bf16 magnus: "
        f"{time.perf_counter() - t0:.1f} s with set-up; " + json.dumps(res))
    log(f"hybrid padded serve batches (size, batch length, G(B), host "
        f"syncs): " + "; ".join(
            f"({r.batch_size}, {r.batch_length}, {r.iterations}, "
            f"{bin(r.iterations).count('1')})" for r in results))
    log(f"hybrid padded serve kernel launches {launches}, plain calls "
        f"{plain}")
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
           cfg.head_dim, d_inner(cfg) // cfg.ssm.head_dim, cfg.ssm.head_dim,
           cfg.ssm.d_state, cfg.ssm.chunk_size, cfg.sliding_window,
           cfg.padded_vocab)
          == (32, 1600, 25, 5, 64, 25, 64, 16, 128, 2048, 32768),
          f"phase 19 did not serve {HYBRID_ARCH} at full width")
    steps = check_padded_serve("phase 19", cfg, res, results, targets)
    sched = padded_schedule(res, engine, results)
    check(sched == HYBRID_SCHEDULE, f"phase 19 schedule {sched}, the CPU "
          f"rehearsal predicted {HYBRID_SCHEDULE}")
    want = {name: 0 for name in launches}
    want.update(flash_attention=layers * len(results),
                ssd_scan=layers * len(results),
                decode_attention=layers * steps)
    check(launches == want, f"phase 19 launches {launches}, not {want}")
    check(not any(plain.values()), f"plain versions ran in phase 19: "
          f"{plain}")
    check(decodes.steps == steps and len(prefills.kept) == len(results)
          and len(scans.kept) == len(results),
          f"phase 19 recorded {decodes.steps} decode steps, "
          f"{len(prefills.kept)} prefills and {len(scans.kept)} scans")
    check_captures("hybrid padded serve", engine, results, rep, steps)
    flash_errs = [hold(torch, "flash_attention (phase 19)",
                       fops.flash_attention(q, k, v, causal=True,
                                            window=window),
                       fref.flash_attention_ref(q, k, v, causal=True,
                                                window=window))
                  for q, k, v in prefills.kept]
    dec_errs = [hold(torch, "decode_attention (phase 19)",
                     ops.decode_attention(q, kc, vc, lens),
                     ref.decode_attention_ref(q, kc, vc, lens))
                for q, kc, vc, lens in decodes.kept]
    check(decodes.kept, "phase 19: no decode step kept")
    log(f"phase 19 held against the plain kernels: {len(flash_errs)} "
        f"batches' layer-0 flash calls (window {window}; max abs err "
        f"{max(e for e, _ in flash_errs):.3e}), {len(dec_errs)} sampled "
        f"decode steps' layer-0 attention (one in {DECODE_SAMPLE} of a "
        f"batch's, replayed ones included; max abs err "
        f"{max(e for e, _ in dec_errs):.3e})")
    big = max(results, key=lambda r: r.batch_size)
    breqs = [r for r in reqs if r.req_id in big.generated]
    cache_len = 1 << (big.batch_length + big.iterations - 1).bit_length()
    profiles = profile_dense_window(torch, engine, breqs, big.batch_length,
                                    cache_len, label="hybrid padded")
    log_profiles(f"hybrid padded decode step at {big.batch_size} rows",
                 profiles)
    ms, wgb, sgb, kgb = padded_step_bound(engine, breqs, big.batch_length, 8)
    log(f"phase 19 decode step bound at {big.batch_size} rows: {ms:.3f} ms "
        f"({wgb:.2f} GB of weights, {sgb:.3f} GB of recurrent state read "
        f"and written, {kgb:.3f} GB of K/V at 3.35 TB/s); graphed busy "
        f"{profiles['graphed']['busy_ms']:.2f} ms is "
        f"{profiles['graphed']['busy_ms'] / ms:.1f}x it")
    log(f"phase 19 serve: {res['token_tp']} tokens/s in {res['wall_s']} s "
        f"(" + "; ".join(f"{label}: {r['token_tp']} in {r['wall_s']} s"
                         for label, r in others.items()) + ")")

    # (b) the window at full width
    long_flash, long_scan = hybrid_long_window(
        torch, ops, ref, fops, fref, sops, sref, ssm_module, transformer,
        engine)

    # (c) the kernels at hymba's own inputs
    t19 = {
        "flash_attention": summarize(
            "flash_attention (phase 19, serve)", *time_flash(
                torch, fops, fref, prefills.kept, spin, window=window)),
        "flash_attention (window)": summarize(
            "flash_attention (phase 19 (b), S 4096, window 2048)",
            *time_flash(torch, fops, fref, [long_flash], spin,
                        window=window)),
        "decode_attention": summarize(
            "decode_attention (phase 19)", *time_dense_decode(
                torch, ops, ref, decodes.kept, spin)),
        "ssd_scan": summarize(
            "ssd_scan (phase 19, serve)", *time_scan(
                torch, sops, sref, scans.kept, spin)),
        "ssd_scan (S 4096)": summarize(
            "ssd_scan (phase 19 (b), S 4096)", *time_scan(
                torch, sops, sref, [long_scan], spin))}
    log(f"phase 19 peak: {torch.cuda.max_memory_allocated() / 2 ** 30:.2f}"
        f" GiB allocated; the phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    del engine, results, rep, prefills, decodes, scans, long_flash, long_scan
    gc.collect()
    torch.cuda.empty_cache()
    return t19, launches


# ---------------------------------------------------------------------------
# phase 20: the MLA family (deepseek-v3-671b) on the padded path
# ---------------------------------------------------------------------------

MLA_ARCH = "deepseek-v3-671b"
# its published widths, cut in depth only: 61 layers to 2 (a layer is
# 11.5 B parameters, 22.9 GB in bf16; a third would leave no room on 80
# GB), and the MTP module (another 22.9 GB, which only training reads)
# dropped
MLA_CUT = dict(num_layers=2, mtp_depth=0)
# the CPU rehearsal's (scripts/mla_vlm_rehearsal.py): memory never binds
MLA_SCHEDULE = dict(
    batches=9, decode_steps=576, host_syncs=9, captures=9, wma_total=28703,
    shapes=[[1, 256, 64], [1, 256, 64], [3, 256, 64], [4, 256, 64],
            [5, 256, 64], [6, 256, 64], [11, 256, 64], [13, 256, 64],
            [20, 256, 64]])
MLA_FREE_BEFORE = 2 << 30      # allocated before the phase: hymba-1.5b's
#                                weights (2.79 GB) must be gone
MLA_TOL = 2e-3                 # absorbed against naive decode, f32, of
#                                the output's scale
# (b): two prompts of 2,048 and 1,500 tokens, so mla_prefill runs two KV
# chunks of 1,024, held against its one-chunk form
MLA_LONG = (2048, 1500)


def mla_config():
    """deepseek-v3-671b at its published widths, cut by ``MLA_CUT``."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(MLA_ARCH), **MLA_CUT)


def mla_naive(torch, q_nope, q_rope, c_kv, k_rope, k_b, v_b, valid, scale):
    """One-token MLA without the absorption, in f32, on the same latent
    cache: K = c_kv @ k_b and V = c_kv @ v_b for every head, a plain
    softmax over the first ``valid`` slots.  Returns o [B, H, Dv]."""
    f = lambda t: t.float()
    k = torch.einsum("bsr,rhd->bshd", f(c_kv), f(k_b))
    v = torch.einsum("bsr,rhd->bshd", f(c_kv), f(v_b))
    sc = (torch.einsum("bhd,bshd->bhs", f(q_nope), k)
          + torch.einsum("bhd,bsd->bhs", f(q_rope), f(k_rope))) * scale
    mask = (torch.arange(c_kv.shape[1], device=sc.device)[None, :]
            < valid[:, None])
    sc = sc.masked_fill(~mask[:, None, :], float("-inf"))
    return torch.einsum("bhs,bshd->bhd", torch.softmax(sc, dim=-1), v)


def mla_long_prefill(torch, transformer, mla_module, engine):
    """Phase 20 (b): two rows of ``MLA_LONG`` tokens prefilled at full
    width, so that ``mla_prefill`` runs two KV chunks of 1,024; layer
    0's output held against the one-chunk form (``chunk = S``) on the
    same inputs: in bf16 as served at 5e-2 of scale, and the same call
    in f32 (weights and input cast, TF32 off) at 2e-4."""
    from repro_torch.models import model as M
    cfg, params = engine.cfg, engine.params
    s, m = max(MLA_LONG), cfg.mla
    gen = torch.Generator(device="cuda").manual_seed(6)
    tokens = torch.randint(3, cfg.vocab_size, (len(MLA_LONG), s),
                           generator=gen, device="cuda", dtype=torch.int32)
    lengths = torch.tensor(MLA_LONG, dtype=torch.int32, device="cuda")
    rec = Recorder(transformer, "mla_prefill", cfg.num_layers,
                   lambda p, x, mm, h, positions, theta: (p, x, positions))
    t0 = time.perf_counter()
    with rec:
        logits, cache = M.prefill(params, cfg, {"tokens": tokens,
                                                "lengths": lengths},
                                  act_dtype=engine.dtype, cache_len=s)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(torch.isfinite(logits.float()).all().item()
          and [t.shape for t in cache["kv"]]
          == [(cfg.num_layers, 2, s, m.kv_lora_rank),
              (cfg.num_layers, 2, s, m.qk_rope_dim)],
          f"phase 20 (b): logits or latent cache {[t.shape for t in cache['kv']]}")
    check(len(rec.kept) == 1, f"phase 20 (b): {len(rec.kept)} prefills")
    p, x, positions = rec.kept[0]
    del cache, rec
    check(mla_module._pick_chunk(s, 1024) == 1024,
          "phase 20 (b): the prefill is not two chunks of 1,024")
    run = lambda pp, xx, chunk: mla_module.mla_prefill(
        pp, xx, m, cfg.num_heads, positions, cfg.rope_theta, chunk=chunk)[0]
    err16, sc16 = hold(torch, "mla_prefill (phase 20 (b), bf16, two "
                       "chunks against one)", run(p, x, 1024), run(p, x, s))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        p32 = {k: v.float() for k, v in p.items()}
        err32, sc32 = hold(torch, "mla_prefill (phase 20 (b), f32)",
                           run(p32, x.float(), 1024),
                           run(p32, x.float(), s), tol=2e-4)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    log(f"phase 20 (b): a prefill of {list(MLA_LONG)} tokens in {wall:.2f} s;"
        f" layer 0's mla_prefill in two KV chunks of 1,024 against one of "
        f"{s}: bf16 max abs err {err16:.3e} at scale {sc16:.1f} (tol 5e-2 "
        f"of scale), f32 {err32:.3e} at scale {sc32:.1f} (tol 2e-4)")


def mla_phase(torch, transformer, mla_module, hbm, others, reset_counts,
              counts):
    """Phase 20: deepseek-v3-671b at its published widths, cut to
    ``MLA_CUT``, in bf16 through the padded launcher's loop
    (``serve_padded``: ``magnus``, ``BatchEngine``) on phase 7's
    requests, its weights drawn on the card from seed 0 once
    hymba-1.5b's are gone.  (a) Checks: as phase 19's (the schedule as
    ``MLA_SCHEDULE``, the CPU rehearsal, predicts), but no kernel
    launches and no plain version runs: MLA is plain PyTorch, as in the
    reference; one capture a batch; at layer 0 of every
    ``DECODE_SAMPLE``-th step of a batch (replayed ones included) the
    absorbed attention held against the naive form (:func:`mla_naive`)
    at ``MLA_TOL``; graphed and eager windows of the largest batch bit
    for bit (both latent leaves, logits, positions), profiled beside the
    step's bound.  (b) :func:`mla_long_prefill`.  (c) Logged: the host
    seconds ``init_params`` took and the peak while it drew, tokens/s
    beside ``others``, the phase's peak allocation.  Returns the serve's
    launches."""
    import gc
    from repro_torch.launch.serve import serve_padded
    from repro_torch.models import model as M
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    log(f"phase 20: {before / 2 ** 30:.2f} GiB allocated before it; "
        f"hbm_bytes {hbm}")
    check(before < MLA_FREE_BEFORE, "hymba-1.5b's weights were not "
          "released before phase 20")
    cfg, t_phase = mla_config(), time.perf_counter()
    m, moe = cfg.mla, cfg.moe
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, m.q_lora_rank,
           m.kv_lora_rank, m.qk_nope_dim, m.qk_rope_dim, m.v_head_dim,
           moe.num_experts, moe.d_ff_expert, moe.top_k, moe.num_shared,
           moe.capacity_factor, cfg.padded_vocab, cfg.mtp_depth)
          == (2, 7168, 128, 1536, 512, 128, 64, 128, 256, 2048, 8, 1, 1.25,
              131072, 0), f"phase 20: {cfg} is not {MLA_ARCH} at its "
          f"published widths cut to {MLA_CUT}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = sum(t.numel() for t in _leaves(params))
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"phase 20: {MLA_ARCH} cut to {MLA_CUT}: {n / 1e9:.2f} B parameters,"
        f" {nbytes / 1e9:.2f} GB ({nbytes / 2 ** 30:.2f} GiB) in bf16 (the "
        f"routers f32), drawn on the card in {init_s:.2f} host s; peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB while drawing")
    reqs, targets = phase7_requests(cfg.vocab_size)
    layers = cfg.num_layers

    def new_batch(*a, **kw):
        decodes.restart()
        return None

    prefills = Recorder(transformer, "mla_prefill", layers, new_batch)
    decodes = Recorder(mla_module, "absorbed_attention", layers,
                       lambda qn, qr, ckv, kr, kb, vb, valid, scale:
                       (qn.clone(), qr.clone(), ckv.clone(), kr.clone(),
                        valid.clone()),
                       every=DECODE_SAMPLE, snap=(0, 1, 6))
    t0 = time.perf_counter()
    with prefills, decodes, replays(decodes) as rep:
        reset_counts()
        res = serve_padded(
            cfg, 0.0, 0.0, "magnus", seed=0, device="cuda",
            dtype=torch.bfloat16, hbm_bytes=hbm, max_len=DENSE_MAX_LEN,
            max_gen=DENSE_MAX_GEN, requests=reqs, params=params)
        launches = counts("launches")
    plain = counts("plain_calls")
    del params                      # the engine holds the same tensors
    engine, results = res.pop("engine"), res.pop("results")
    log(f"MLA padded serve {MLA_ARCH} (cut {MLA_CUT}) bf16 magnus: "
        f"{time.perf_counter() - t0:.1f} s; " + json.dumps(res))
    log(f"MLA padded serve batches (size, batch length, G(B), host "
        f"syncs): " + "; ".join(
            f"({r.batch_size}, {r.batch_length}, {r.iterations}, "
            f"{bin(r.iterations).count('1')})" for r in results))
    steps = check_padded_serve("phase 20", cfg, res, results, targets)
    sched = padded_schedule(res, engine, results)
    check(sched == MLA_SCHEDULE, f"phase 20 schedule {sched}, the CPU "
          f"rehearsal predicted {MLA_SCHEDULE}")
    check(not any(launches.values()) and not any(plain.values()),
          f"phase 20 launched {launches}, plain calls {plain}: MLA runs "
          f"no attention kernel and no plain version")
    check(prefills.steps == len(results) and decodes.steps == steps,
          f"phase 20 recorded {prefills.steps} prefills and "
          f"{decodes.steps} decode steps")
    check_captures("MLA padded serve", engine, results, rep, steps)
    check(decodes.kept, "phase 20: no decode step kept")
    mp = {k: v[0] for k, v in engine.params["blocks"]["mla"].items()}
    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        errs = [hold(torch, "MLA absorbed decode against naive (phase 20)",
                     mla_module.absorbed_attention(
                         qn, qr, ckv, kr, mp["k_b"], mp["v_b"], valid,
                         scale),
                     mla_naive(torch, qn, qr, ckv, kr, mp["k_b"], mp["v_b"],
                               valid, scale), tol=MLA_TOL)
                for qn, qr, ckv, kr, valid in decodes.kept]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    log(f"phase 20 held: {len(errs)} sampled decode steps' layer-0 absorbed "
        f"attention (one in {DECODE_SAMPLE} of a batch's, replayed ones "
        f"included) against the naive form in f32: max abs err "
        f"{max(e for e, _ in errs):.3e} at scale up to "
        f"{max(sc for _, sc in errs):.1f} (tol {MLA_TOL} of scale)")
    big = max(results, key=lambda r: r.batch_size)
    breqs = [r for r in reqs if r.req_id in big.generated]
    cache_len = 1 << (big.batch_length + big.iterations - 1).bit_length()
    profiles = profile_dense_window(torch, engine, breqs, big.batch_length,
                                    cache_len, label="MLA padded",
                                    kernel=None)
    log_profiles(f"MLA padded decode step at {big.batch_size} rows",
                 profiles)
    ms, wgb, _, kgb = padded_step_bound(engine, breqs, big.batch_length, 8)
    log(f"phase 20 decode step bound at {big.batch_size} rows: {ms:.3f} ms "
        f"({wgb:.2f} GB of weights, every expert's, and {kgb:.4f} GB of "
        f"latents at 3.35 TB/s); graphed busy "
        f"{profiles['graphed']['busy_ms']:.2f} ms is "
        f"{profiles['graphed']['busy_ms'] / ms:.2f}x it")
    log(f"phase 20 serve: {res['token_tp']} tokens/s in {res['wall_s']} s "
        f"(" + "; ".join(f"{label}: {r['token_tp']} in {r['wall_s']} s"
                         for label, r in others.items()) + ")")
    del rep, prefills, decodes, errs
    mla_long_prefill(torch, transformer, mla_module, engine)
    log(f"phase 20 peak: {torch.cuda.max_memory_allocated() / 2 ** 30:.2f}"
        f" GiB allocated; the phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    del engine, results
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 21: the vlm family (internvl2-26b) on the padded path
# ---------------------------------------------------------------------------

VLM_ARCH = "internvl2-26b"
# the CPU rehearsal's (scripts/mla_vlm_rehearsal.py): memory never binds
VLM_SCHEDULE = dict(
    batches=9, decode_steps=576, host_syncs=9, captures=9, wma_total=28703,
    shapes=[[1, 256, 64], [1, 256, 64], [3, 256, 64], [4, 256, 64],
            [5, 256, 64], [6, 256, 64], [11, 256, 64], [13, 256, 64],
            [20, 256, 64]])
VLM_FREE_BEFORE = 2 << 30      # deepseek-v3-671b's weights must be gone


def vlm_phase(torch, ops, ref, fops, fref, transformer, hbm, spin, others,
              reset_counts, counts):
    """Phase 21: internvl2-26b uncut (48 layers, d_model 6144, 48 query
    heads over 8 KV heads of 128, 256 patches) in bf16 through
    ``run_engine_backend`` (``magnus``, the padded ``BatchEngine``, zero
    patches in front of every prompt) on phase 7's requests, its
    weights drawn on the card from seed 0 once deepseek-v3-671b's are
    gone.  Checks: as phase 19's (the schedule as ``VLM_SCHEDULE``
    predicts); flash 48 times a batch at S = bl + 256, dense decode 48
    times a step on a ``_bucket(bl + G(B) + 256)`` cache, nothing else
    and no plain version; one capture a batch; each batch's layer-0
    flash call and a sample of decode steps held as phase 6 holds;
    graphed and eager windows of the largest batch bit for bit, profiled
    beside the step's bound.  Both kernels timed at these inputs as
    phase 8 times them.  Logged: tokens/s beside ``others``, the peak
    allocation.  Returns (the timings, the serve's launches)."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import run_engine_backend
    from repro_torch.serving.engine import _bucket
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    log(f"phase 21: {before / 2 ** 30:.2f} GiB allocated before it")
    check(before < VLM_FREE_BEFORE, "deepseek-v3-671b's weights were not "
          "released before phase 21")
    vcfg = get_config(VLM_ARCH)
    reqs, targets = phase7_requests(vcfg.vocab_size)
    layers, patches = vcfg.num_layers, vcfg.num_patches
    prefills, decodes = dense_recorders(transformer, layers)
    t_phase = t0 = time.perf_counter()
    with prefills, decodes, replays(decodes) as rep:
        reset_counts()
        res = run_engine_backend(
            VLM_ARCH, 0.0, 0.0, "magnus", seed=0, reduced=False,
            device="cuda", dtype=torch.bfloat16, hbm_bytes=hbm,
            max_len=DENSE_MAX_LEN, max_gen=DENSE_MAX_GEN, requests=reqs)
        launches = counts("launches")
    plain = counts("plain_calls")
    engine, results = res.pop("engine"), res.pop("results")
    cfg = engine.cfg
    log(f"vlm padded serve {VLM_ARCH} full width bf16 magnus: "
        f"{time.perf_counter() - t0:.1f} s with set-up; " + json.dumps(res))
    log(f"vlm padded serve batches (size, batch length, G(B), host "
        f"syncs): " + "; ".join(
            f"({r.batch_size}, {r.batch_length}, {r.iterations}, "
            f"{bin(r.iterations).count('1')})" for r in results))
    log(f"vlm padded serve kernel launches {launches}, plain calls {plain}")
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
           cfg.head_dim, cfg.d_ff, cfg.num_patches, cfg.rope_theta,
           cfg.padded_vocab)
          == (48, 6144, 48, 8, 128, 16384, 256, 1e6, 94208),
          f"phase 21 did not serve {VLM_ARCH} at full width")
    steps = check_padded_serve("phase 21", cfg, res, results, targets)
    sched = padded_schedule(res, engine, results)
    check(sched == VLM_SCHEDULE, f"phase 21 schedule {sched}, the CPU "
          f"rehearsal predicted {VLM_SCHEDULE}")
    want = {name: 0 for name in launches}
    want.update(flash_attention=layers * len(results),
                decode_attention=layers * steps)
    check(launches == want, f"phase 21 launches {launches}, not {want}")
    check(not any(plain.values()), f"plain versions ran in phase 21: "
          f"{plain}")
    check(decodes.steps == steps and prefills.steps == len(results),
          f"phase 21 recorded {decodes.steps} decode steps and "
          f"{prefills.steps} prefills")
    check_captures("vlm padded serve", engine, results, rep, steps)
    lens = sorted({r.batch_length + patches for r in results})
    check(all(q.shape[1] in lens and (q.shape[2], k.shape[2], q.shape[3])
              == (48, 8, 128) for q, k, _ in prefills.kept),
          f"phase 21: flash shapes {[tuple(q.shape) for q, _, _ in prefills.kept]}"
          f", not S in {lens} at 48/8 heads of 128")
    slots = {_bucket(r.batch_length + r.iterations + patches)
             for r in results}
    check(all(kc.shape[1] in slots for _, kc, _, _ in decodes.kept),
          f"phase 21: decode caches of "
          f"{sorted({kc.shape[1] for _, kc, _, _ in decodes.kept})} slots, "
          f"not {sorted(slots)}")
    flash_errs = [hold(torch, "flash_attention (phase 21)",
                       fops.flash_attention(q, k, v, causal=True),
                       fref.flash_attention_ref(q, k, v, causal=True))
                  for q, k, v in prefills.kept]
    dec_errs = [hold(torch, "decode_attention (phase 21)",
                     ops.decode_attention(q, kc, vc, ln),
                     ref.decode_attention_ref(q, kc, vc, ln))
                for q, kc, vc, ln in decodes.kept]
    check(prefills.kept and decodes.kept, "phase 21: nothing kept")
    log(f"phase 21 held against the plain kernels: {len(flash_errs)} "
        f"batches' layer-0 flash calls at S {lens} (max abs err "
        f"{max(e for e, _ in flash_errs):.3e}), {len(dec_errs)} sampled "
        f"decode steps' layer-0 attention on caches of {sorted(slots)} "
        f"slots (max abs err {max(e for e, _ in dec_errs):.3e})")
    big = max(results, key=lambda r: r.batch_size)
    breqs = [r for r in reqs if r.req_id in big.generated]
    cache_len = _bucket(big.batch_length + big.iterations + patches)
    profiles = profile_dense_window(torch, engine, breqs, big.batch_length,
                                    cache_len, label="vlm padded")
    log_profiles(f"vlm padded decode step at {big.batch_size} rows",
                 profiles)
    ms, wgb, _, kgb = padded_step_bound(engine, breqs, big.batch_length, 8)
    log(f"phase 21 decode step bound at {big.batch_size} rows: {ms:.3f} ms "
        f"({wgb:.2f} GB of weights, {kgb:.3f} GB of K/V with the patch "
        f"prefix at 3.35 TB/s); graphed busy "
        f"{profiles['graphed']['busy_ms']:.2f} ms is "
        f"{profiles['graphed']['busy_ms'] / ms:.2f}x it")
    log(f"phase 21 serve: {res['token_tp']} tokens/s in {res['wall_s']} s "
        f"(" + "; ".join(f"{label}: {r['token_tp']} in {r['wall_s']} s"
                         for label, r in others.items()) + ")")
    del engine, results, rep
    gc.collect()
    torch.cuda.empty_cache()
    t21 = {
        "flash_attention": summarize(
            "flash_attention (phase 21)", *time_flash(
                torch, fops, fref, prefills.kept, spin)),
        "decode_attention": summarize(
            "decode_attention (phase 21)", *time_dense_decode(
                torch, ops, ref, decodes.kept, spin))}
    log(f"phase 21 peak: {torch.cuda.max_memory_allocated() / 2 ** 30:.2f}"
        f" GiB allocated; the phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    del prefills, decodes
    gc.collect()
    torch.cuda.empty_cache()
    return t21, launches


# ---------------------------------------------------------------------------
# phase 22: the encoder-decoder family (whisper-large-v3) on the padded path
# ---------------------------------------------------------------------------

ENCDEC_ARCH = "whisper-large-v3"
# the CPU rehearsal's (scripts/encdec_rehearsal.py): the batcher on
# whisper-large-v3's memory model (each request's cross K/V priced at
# 1,500 rows) at an H100 80GB's memory
ENCDEC_SCHEDULE = dict(
    batches=9, decode_steps=576, host_syncs=9, captures=9, wma_total=28703,
    shapes=[[1, 256, 64], [1, 256, 64], [3, 256, 64], [4, 256, 64],
            [5, 256, 64], [6, 256, 64], [11, 256, 64], [13, 256, 64],
            [20, 256, 64]])
ENCDEC_FREE_BEFORE = 2 << 30   # internvl2-26b's weights must be gone
# (a): the flash kernel's full mode with a key bound at whisper's heads
# (20 of 64, G 1): (B, Sq, Sk, kv_len): the encoder over 1,536 padded
# frames with 1,500 real, the cross prefill at prompt buckets 64 and 256
# against them, and bounds off the 64-key tile at small S
ENCDEC_FLASH = [(1, 1536, 1536, 1500), (4, 1536, 1536, 1500),
                (4, 64, 1536, 1500), (2, 256, 1536, 1500),
                (3, 8, 130, 100), (2, 77, 77, 50)]
# (b): the dense decode kernel on a 1,536-row cross cache read to 1,500
# keys, at one row and at the serve's largest batch
ENCDEC_DECODE_ROWS = (1, 20)


def encdec_kernel_checks(torch, fops, fref, ops, ref):
    """Phase 22 (a) and (b) at whisper-large-v3's heads (20 of 64): the
    flash kernel's full mode with Sq != Sk and a key bound
    (``ENCDEC_FLASH``), and the dense decode kernel on a cross cache of
    1,536 rows at length 1,500 (``ENCDEC_DECODE_ROWS``), each against
    its plain version in f32 (TF32 off, 2e-4) and bf16 (2e-2), each of
    the output's own largest magnitude with no floor (averages over
    1,500 random keys are about 0.04, so a floor of 1 would hide a key
    let in past the bound); NaN written into the K/V rows from the
    bound to the end must change each kernel's output by exactly 0, and
    a bounded flash call must equal, bit for bit, the call on K and V
    cut to the bound (the same tiles run, so a wrong bound mask shows
    even where the bf16 tensor maps zero-fill past the bound)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(22)
    h, d = 20, 64
    rand = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    nan = float("nan")
    errs = {}
    for dt, name, tol in ((torch.float32, "f32", 2e-4),
                          (torch.bfloat16, "bf16", 2e-2)):
        for b, sq, sk, kv in ENCDEC_FLASH:
            q = rand(b, sq, h, d).to(dt)
            k, v = rand(b, sk, h, d).to(dt), rand(b, sk, h, d).to(dt)
            out = fops.flash_attention(q, k, v, causal=False, kv_len=kv)
            label = (f"flash_attention full mode ({name}, B {b}, Sq {sq}, "
                     f"Sk {sk}, kv_len {kv})")
            err, scale = hold(torch, label, out, fref.flash_attention_ref(
                q, k, v, causal=False, kv_len=kv), tol=tol, floor=0.0)
            check(torch.equal(fops.flash_attention(
                q, k[:, :kv].contiguous(), v[:, :kv].contiguous(),
                causal=False), out),
                f"{label}: differs from the call on K and V cut to the bound")
            kp, vp = k.clone(), v.clone()
            kp[:, kv:], vp[:, kv:] = nan, nan
            check(torch.equal(fops.flash_attention(
                q, kp, vp, causal=False, kv_len=kv), out),
                f"{label}: NaN past the key bound changed the output")
            errs[f"flash {name}"] = max(err / scale,
                                        errs.get(f"flash {name}", 0))
        for b in ENCDEC_DECODE_ROWS:
            q = rand(b, h, d).to(dt)
            kc, vc = (rand(b, 1536, h, d).to(dt) for _ in range(2))
            lens = torch.full((b,), 1500, dtype=torch.int32, device="cuda")
            out = ops.decode_attention(q, kc, vc, lens)
            label = f"decode_attention on a cross cache ({name}, B {b})"
            err, scale = hold(torch, label, out, ref.decode_attention_ref(
                q, kc, vc, lens), tol=tol, floor=0.0)
            kc[:, 1500:], vc[:, 1500:] = nan, nan
            check(torch.equal(ops.decode_attention(q, kc, vc, lens), out),
                  f"{label}: NaN past the length changed the output")
            errs[f"decode {name}"] = max(err / scale,
                                         errs.get(f"decode {name}", 0))
    log(f"phase 22 (a), (b): flash full mode with a key bound at "
        f"{len(ENCDEC_FLASH)} shapes {ENCDEC_FLASH} and dense decode on "
        f"1,536-row cross caches at length 1,500 ({ENCDEC_DECODE_ROWS} "
        f"rows), 20 heads of 64, held against the plain versions (max abs "
        f"err over the output's largest magnitude "
        f"{json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})}"
        f"; f32 tol 2e-4, bf16 2e-2); each bounded flash call equal bit "
        f"for bit to the call on K and V cut to the bound; NaN past the "
        f"bound changed no output bit")


def encdec_model_check(torch, np):
    """Phase 22 (c): reduced whisper-large-v3 (2 + 2 layers, 16 frames
    padded to 512) in f32 on the card against the CPU, as phase 4 checks
    chatglm-6b: random frames, right-padded prompts, a prefill into a
    64-slot cache and a fused decode window.  The prefill's logits and
    the window's are held at 2e-4 (relative to 1 + their scale) and the
    greedy tokens must be equal; the caches' distance is logged."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.params import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(ENCDEC_ARCH).reduced()
    params_cpu = init_params(cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu")
    rng = np.random.default_rng(22)
    b, s, steps = 3, 32, 6
    tokens = rng.integers(3, cfg.vocab_size, size=(b, s))
    lengths = np.array([32, 17, 5])
    frames = rng.standard_normal((b, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)
    results = {}
    for dev in ("cpu", "cuda"):
        params = params_cpu if dev == "cpu" else _to(torch, params_cpu, dev)
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int32,
                                      device=dev)
        logits, cache = M.prefill(params, cfg, {
            "tokens": t(tokens), "lengths": t(lengths),
            "frames": torch.as_tensor(frames, device=dev)},
            act_dtype=torch.float32, cache_len=64)
        first = logits.clone()
        caches = [c.clone() for key in ("kv", "cross") for c in cache[key]]
        logits, cache, _, toks = M.decode_multi(
            params, cfg, cache, {"logits": logits, "positions": t(lengths)},
            num_steps=steps, act_dtype=torch.float32)
        results[dev] = ([first, logits], caches + list(cache["kv"]),
                        toks.cpu())
    errs = _rel_errs(torch, results["cuda"][0], results["cpu"][0])
    cache_errs = _rel_errs(torch, results["cuda"][1], results["cpu"][1])
    same = torch.equal(results["cuda"][2], results["cpu"][2])
    log(f"phase 22 (c): {ENCDEC_ARCH} reduced f32 card vs cpu: max rel err "
        f"{max(errs):.3e} (tol 2e-4) over the prefill's logits and the "
        f"logits after {steps} fused decode steps; tokens equal: {same}; "
        f"the caches (self and cross after the prefill, self after the "
        f"window) differ by up to {max(cache_errs):.3e} of 1 + their scale")
    check(same, "whisper decode tokens differ between card and cpu")
    check(max(errs) <= 2e-4, f"whisper model card vs cpu: {errs}")


def encdec_recorders(encdec, enc_layers, dec_layers):
    """Recorders of whisper's layer-0 attention inputs in a padded serve:
    every prefill's encoder, decoder self-attention and cross attention
    flash calls (a prefill makes ``enc_layers + 2 * dec_layers`` calls,
    the encoder's first, then a self and a cross call a decoder layer),
    and every ``DECODE_SAMPLE``-th decode step's self and cross decode
    calls (two a layer), the step's layer-0 caches cloned, up to
    ``KEEP_BYTES`` in all.  Returns (encoder, self, cross, self decode,
    cross decode)."""
    left = [KEEP_BYTES]
    calls = enc_layers + 2 * dec_layers

    def afford(*ts):
        n = sum(t.nbytes for t in ts)
        if n > left[0]:
            return False
        left[0] -= n
        return True

    def keep_prefill(causal_want, restart=False):
        def keep(q, k, v, *, causal=True, window=None, kv_len=None):
            check(causal == causal_want and window is None,
                  f"whisper prefill call: causal {causal}, window {window}")
            if restart:                       # a new batch
                dec_self.restart()
                dec_cross.restart()
            return (q, k, v, kv_len) if afford(q, k, v) else None
        return keep

    def keep_decode(q, kc, vc, lengths):
        if afford(kc, vc):
            return q[:, 0].clone(), kc.clone(), vc.clone(), lengths.clone()
        return None

    enc = Recorder(encdec, "gqa_prefill_attention", calls,
                   keep_prefill(False, restart=True), at=0)
    self_ = Recorder(encdec, "gqa_prefill_attention", calls,
                     keep_prefill(True), at=enc_layers)
    cross = Recorder(encdec, "gqa_prefill_attention", calls,
                     keep_prefill(False), at=enc_layers + 1)
    dec_self = Recorder(encdec, "gqa_decode_attention", 2 * dec_layers,
                        keep_decode, every=DECODE_SAMPLE, snap=(0, 3), at=0)
    dec_cross = Recorder(encdec, "gqa_decode_attention", 2 * dec_layers,
                         keep_decode, every=DECODE_SAMPLE, snap=(0, 3), at=1)
    return enc, self_, cross, dec_self, dec_cross


class encoder_timer:
    """Inside the ``with`` block, each call of ``encdec.encode`` (one a
    padded batch's prefill) is bracketed by CUDA events; ``ms()`` gives
    each call's card time once the work is done."""

    def __init__(self, encdec):
        self.module, self.events = encdec, []

    def __enter__(self):
        import torch
        self.orig = orig = self.module.encode

        def timed(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = orig(*a, **kw)
            end.record()
            self.events.append((start, end, a[2].shape[0]))
            return out

        self.module.encode = timed
        return self

    def __exit__(self, *exc):
        self.module.encode = self.orig

    def ms(self):
        return [(rows, round(s.elapsed_time(e), 3))
                for s, e, rows in self.events]


def encdec_step_bound(engine, reqs, bl, steps):
    """A padded whisper decode step's least time at the profiled batch:
    the decoder's weights (every decoder block but its cross
    attention's K and V projections, which only the prefill reads, its
    final LayerNorm and the embedding, read as the tied LM head) once,
    each row's self K/V
    at the window's mean length and its cross K/V at ``encoder_seq``
    rows (what decode reads of it) once, at 3.35 TB/s.  Returns (ms,
    weights GB, self K/V GB, cross K/V GB)."""
    cfg, p = engine.cfg, engine.params
    blocks = dict(p["dec_blocks"])
    blocks["cross"] = {k: t for k, t in blocks["cross"].items()
                       if k not in ("wk", "wv", "bv")}
    weights = sum(t.numel() * t.element_size() for t in
                  _leaves({"dec_blocks": blocks, "dec_ln": p["dec_ln"],
                           "embed": p["embed"]}))
    per_token = 2 * cfg.num_layers * cfg.num_heads * cfg.head_dim * 2
    tokens = sum(min(r.length, bl) + steps / 2 for r in reqs)
    kv = tokens * per_token
    cross = len(reqs) * cfg.encoder_seq * per_token
    total = weights + kv + cross
    return (total / HBM_BYTES_PER_S * 1e3, weights / 1e9, kv / 1e9,
            cross / 1e9)


def encdec_phase(torch, np, ops, ref, fops, fref, hbm, spin, others,
                 reset_counts, counts):
    """Phase 22: whisper-large-v3 uncut (32 encoder and 32 decoder
    layers, d_model 1280, 20 heads of 64, 1,500 audio frames padded to
    1,536) in bf16, random weights from seed 0 once internvl2-26b's are
    gone.  (a), (b): :func:`encdec_kernel_checks`; (c):
    :func:`encdec_model_check`; (d): a serve through
    ``run_engine_backend`` (``magnus``, the padded ``BatchEngine``, zero
    frames) on phase 7's requests with ``hbm_bytes`` the card's memory.
    Checks of (d): as phase 21's (the schedule as ``ENCDEC_SCHEDULE``
    predicts); flash 96 times a batch (the encoder's 32 layers at Sq =
    Sk = 1,536 with 1,500 keys, then a causal self-attention and a
    cross attention at Sq = bl, Sk = 1,536, 1,500 keys in each decoder
    layer), dense decode 64 times a step (self on the batch's
    ``_bucket(bl + G(B))``-slot cache, cross on the 1,536-row cross
    cache at 1,500), nothing else and no plain version; one capture a
    batch; each batch's three layer-0 flash calls and a sample of decode
    steps' two layer-0 decode calls held as phase 6 holds; graphed and
    eager windows of the largest batch bit for bit, profiled beside the
    step's bound.  Logged: tokens/s beside ``others``, each batch's
    encoder ms, the peak allocation.  Returns (the timings at these
    inputs, the serve's launches)."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import run_engine_backend
    from repro_torch.models import encdec
    from repro_torch.serving.engine import _bucket
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    log(f"phase 22: {before / 2 ** 30:.2f} GiB allocated before it")
    check(before < ENCDEC_FREE_BEFORE, "internvl2-26b's weights were not "
          "released before phase 22")
    t_phase = time.perf_counter()
    encdec_kernel_checks(torch, fops, fref, ops, ref)
    encdec_model_check(torch, np)

    ecfg = get_config(ENCDEC_ARCH)
    reqs, targets = phase7_requests(ecfg.vocab_size)
    nenc, ndec = ecfg.encoder_layers, ecfg.num_layers
    recs = encdec_recorders(encdec, nenc, ndec)
    enc, self_, cross, dec_self, dec_cross = recs
    t0 = time.perf_counter()
    with enc, self_, cross, dec_self, dec_cross, \
            replays(dec_self, dec_cross) as rep, encoder_timer(encdec) as et:
        reset_counts()
        res = run_engine_backend(
            ENCDEC_ARCH, 0.0, 0.0, "magnus", seed=0, reduced=False,
            device="cuda", dtype=torch.bfloat16, hbm_bytes=hbm,
            max_len=DENSE_MAX_LEN, max_gen=DENSE_MAX_GEN, requests=reqs)
        launches = counts("launches")
    plain = counts("plain_calls")
    engine, results = res.pop("engine"), res.pop("results")
    cfg = engine.cfg
    log(f"enc-dec padded serve {ENCDEC_ARCH} full width bf16 magnus: "
        f"{time.perf_counter() - t0:.1f} s with set-up; " + json.dumps(res))
    log(f"enc-dec padded serve batches (size, batch length, G(B), host "
        f"syncs): " + "; ".join(
            f"({r.batch_size}, {r.batch_length}, {r.iterations}, "
            f"{bin(r.iterations).count('1')})" for r in results))
    log(f"enc-dec padded serve kernel launches {launches}, plain calls "
        f"{plain}")
    log(f"phase 22 encoder per batch (rows, card ms from CUDA events): "
        f"{et.ms()}")
    nparams = sum(t.numel() for t in _leaves(engine.params))
    check((cfg.encoder_layers, cfg.num_layers, cfg.d_model, cfg.num_heads,
           cfg.head_dim, cfg.d_ff, cfg.encoder_seq, cfg.padded_vocab)
          == (32, 32, 1280, 20, 64, 5120, 1500, 53248),
          f"phase 22 did not serve {ENCDEC_ARCH} at full width")
    log(f"phase 22: {nparams / 1e9:.3f} B parameters, "
        f"{nparams * 2 / 1e9:.2f} GB in bf16")
    steps = check_padded_serve("phase 22", cfg, res, results, targets)
    sched = padded_schedule(res, engine, results)
    check(sched == ENCDEC_SCHEDULE, f"phase 22 schedule {sched}, the CPU "
          f"rehearsal predicted {ENCDEC_SCHEDULE}")
    want = {name: 0 for name in launches}
    want.update(flash_attention=(nenc + 2 * ndec) * len(results),
                decode_attention=2 * ndec * steps)
    check(launches == want, f"phase 22 launches {launches}, not {want}")
    check(not any(plain.values()), f"plain versions ran in phase 22: "
          f"{plain}")
    check(enc.steps == self_.steps == cross.steps == len(results)
          and dec_self.steps == dec_cross.steps == steps,
          f"phase 22 recorded {enc.steps}/{self_.steps}/{cross.steps} "
          f"prefills and {dec_self.steps}/{dec_cross.steps} decode steps")
    check(len(et.events) == len(results),
          f"phase 22: {len(et.events)} encoder calls for {len(results)} "
          f"batches")
    check_captures("enc-dec padded serve", engine, results, rep, steps)
    frames = -(-cfg.encoder_seq // 512) * 512
    lens = {r.batch_length for r in results}
    check(all(tuple(q.shape[1:]) == (frames, 20, 64)
              and k.shape[1] == frames and kv == cfg.encoder_seq
              for q, k, _, kv in enc.kept)
          and all(k.shape[1] == frames and kv == cfg.encoder_seq
                  and q.shape[1] in lens for q, k, _, kv in cross.kept)
          and all(q.shape[1] == k.shape[1] and q.shape[1] in lens
                  and kv is None for q, k, _, kv in self_.kept),
          "phase 22: prefill shapes " + str(
              [(tuple(q.shape), k.shape[1], kv) for rec in (enc, self_, cross)
               for q, k, _, kv in rec.kept]))
    slots = {_bucket(r.batch_length + r.iterations) for r in results}
    check(all(kc.shape[1] in slots for _, kc, _, _ in dec_self.kept)
          and all(kc.shape[1] == frames and int(ln.min()) == int(ln.max())
                  == cfg.encoder_seq for _, kc, _, ln in dec_cross.kept),
          f"phase 22: decode caches of "
          f"{sorted({kc.shape[1] for _, kc, _, _ in dec_self.kept})} and "
          f"{sorted({kc.shape[1] for _, kc, _, _ in dec_cross.kept})} rows")
    flash_errs = [hold(torch, "flash_attention (phase 22)",
                       fops.flash_attention(q, k, v, causal=kv is None,
                                            kv_len=kv),
                       fref.flash_attention_ref(q, k, v, causal=kv is None,
                                                kv_len=kv))
                  for rec in (enc, self_, cross) for q, k, v, kv in rec.kept]
    dec_errs = [hold(torch, "decode_attention (phase 22)",
                     ops.decode_attention(q, kc, vc, ln),
                     ref.decode_attention_ref(q, kc, vc, ln))
                for rec in (dec_self, dec_cross) for q, kc, vc, ln in rec.kept]
    check(all(r.kept for r in recs), "phase 22: nothing kept")
    log(f"phase 22 held against the plain kernels: {len(flash_errs)} "
        f"layer-0 flash calls (encoder, self, cross of each batch; max abs "
        f"err {max(e for e, _ in flash_errs):.3e}), {len(dec_errs)} "
        f"sampled decode steps' layer-0 self and cross attention (max abs "
        f"err {max(e for e, _ in dec_errs):.3e})")
    big = max(results, key=lambda r: r.batch_size)
    breqs = [r for r in reqs if r.req_id in big.generated]
    cache_len = _bucket(big.batch_length + big.iterations)
    profiles = profile_dense_window(torch, engine, breqs, big.batch_length,
                                    cache_len, label="enc-dec padded")
    log_profiles(f"enc-dec padded decode step at {big.batch_size} rows",
                 profiles)
    ms, wgb, kgb, cgb = encdec_step_bound(engine, breqs, big.batch_length, 8)
    log(f"phase 22 decode step bound at {big.batch_size} rows: {ms:.3f} ms "
        f"({wgb:.2f} GB of decoder weights, {kgb:.3f} GB of self K/V, "
        f"{cgb:.2f} GB of cross K/V at {cfg.encoder_seq} rows, at 3.35 "
        f"TB/s); graphed busy {profiles['graphed']['busy_ms']:.2f} ms is "
        f"{profiles['graphed']['busy_ms'] / ms:.2f}x it")
    log(f"phase 22 serve: {res['token_tp']} tokens/s in {res['wall_s']} s "
        f"(" + "; ".join(f"{label}: {r['token_tp']} in {r['wall_s']} s"
                         for label, r in others.items()) + ")")
    del engine, results, rep
    gc.collect()
    torch.cuda.empty_cache()
    t22 = {
        "flash_attention encoder": summarize(
            "flash_attention (phase 22, encoder)", *time_flash(
                torch, fops, fref, [c[:3] for c in enc.kept], spin,
                kv_len=cfg.encoder_seq)),
        "flash_attention cross prefill": summarize(
            "flash_attention (phase 22, cross prefill)", *time_flash(
                torch, fops, fref, [c[:3] for c in cross.kept], spin,
                kv_len=cfg.encoder_seq)),
        "flash_attention self": summarize(
            "flash_attention (phase 22, decoder self)", *time_flash(
                torch, fops, fref, [c[:3] for c in self_.kept], spin)),
        "decode_attention self": summarize(
            "decode_attention (phase 22, self)", *time_dense_decode(
                torch, ops, ref, dec_self.kept, spin)),
        "decode_attention cross": summarize(
            "decode_attention (phase 22, cross)", *time_dense_decode(
                torch, ops, ref, dec_cross.kept, spin))}
    log(f"phase 22 peak: {torch.cuda.max_memory_allocated() / 2 ** 30:.2f}"
        f" GiB allocated; the phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    del recs, enc, self_, cross, dec_self, dec_cross
    gc.collect()
    torch.cuda.empty_cache()
    return t22, launches


# ---------------------------------------------------------------------------
# phase 23: training
# ---------------------------------------------------------------------------

TRAIN_ARCH = "smollm-135m"
TRAIN_STEPS = 10
TRAIN_TOL = 2e-4               # f32 with TF32 off, of the value's scale
TRAIN_TOLS = {"float32": TRAIN_TOL,   # the reference's holds by dtype
              "bfloat16": 5e-2}
TRAIN_BF16_FACTOR = 2.0        # (e): a leaf of the card's bf16 step from
#                                the CPU's bf16 step, against the CPU's
#                                bf16 distance from its f32 step (two bf16
#                                runs each that far from f32 are at most
#                                twice as far from each other)
TRAIN_F32_FACTOR = 2.0         # phase 24 (b): the card's f32 step from
#                                the CPU's f64 step, against the card's f32
#                                step through the plain versions (where f32
#                                rounding dominates a leaf, a kernel that
#                                sums in another order lands about as far,
#                                on either side; at seeds 0 and 1 at most
#                                1.73x, scripts/ssm_train_hold.py)
TRAIN_CPU_LAYERS = 2           # the card-against-CPU step's depth
TRAIN_REPS = 7                 # timed calls per kernel
# (B, Sq, Sk, Hq, Hkv, D, causal, window, kv_len): smollm-135m's training
# call first (the timed one), then the other modes (a window, G 1 and 3,
# D 32 and 128, a key bound) and whisper-large-v3's encoder, cross and
# decoder calls (20 heads of 64, 1,500 of 1,536 frames, 448 text rows)
TRAIN_BWD = [(8, 256, 256, 9, 3, 64, True, None, None),
             (2, 200, 200, 6, 2, 32, True, 64, None),
             (2, 100, 100, 4, 4, 128, True, 7, None),
             (3, 70, 70, 6, 2, 64, False, None, 45),
             (1, 1536, 1536, 20, 20, 64, False, None, 1500),
             (2, 448, 1536, 20, 20, 64, False, None, 1500),
             (2, 448, 448, 20, 20, 64, True, None, None)]


def train_kernel_checks(torch, fops, fref):
    """Phase 23 (a): the flash forward (out and its log-sum-exp) and the
    backward kernel against their plain versions on ``TRAIN_BWD``'s
    calls, in f32 (TF32 off) and bf16: out, dq, dk and dv each to
    ``TRAIN_TOLS`` of its own largest magnitude (no floor), lse (f32 in
    both) to ``TRAIN_TOL``; a second launch of the backward must give
    the same bits; where a key bound is given, NaN written into K and V
    past it must leave out, lse, dq and the bounded rows of dk and dv
    unchanged bit for bit and the rows past it zero.  The autograd
    wrapper at smollm-135m's call, in both dtypes, launches the forward
    and the backward once each and matches autograd of the plain
    version.  Returns the largest error over scale of each output."""
    from repro_torch.kernels.flash_attention import kernel as fkernel
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(23)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).rsplit(".", 1)[-1]
        tol = TRAIN_TOLS[dname]
        rand = lambda *shape: torch.randn(*shape, generator=gen,
                                          device="cuda").to(dtype)

        def held(label, name, got, want, tol=tol):
            err, scale = hold(torch, f"{label} {name}", got, want, tol=tol,
                              floor=0.0)
            key = f"{dname} {name}"
            errs[key] = max(errs.get(key, 0.0), err / scale)

        for b, sq, sk, hq, hkv, d, causal, window, kv in TRAIN_BWD:
            mode = dict(causal=causal, window=window, kv_len=kv)
            q, dout = rand(b, sq, hq, d), rand(b, sq, hq, d)
            k, v = rand(b, sk, hkv, d), rand(b, sk, hkv, d)
            label = (f"flash backward {dname} (B {b}, Sq {sq}, Sk {sk}, "
                     f"{hq}/{hkv} heads of {d}, {mode})")
            out, lse = fkernel.flash_attention_kernel(q, k, v, with_lse=True,
                                                      **mode)
            want_out, want_lse = fref.flash_attention_ref(
                q, k, v, with_lse=True, **mode)
            held(label, "out", out, want_out)
            held(label, "lse", lse, want_lse, tol=TRAIN_TOL)
            got = fkernel.flash_attention_bwd_kernel(q, k, v, out, dout, lse,
                                                     **mode)
            want = fref.flash_attention_bwd_ref(q, k, v, want_out, dout,
                                                want_lse, **mode)
            for name, g, w in zip(("dq", "dk", "dv"), got, want):
                held(label, name, g, w)
            again = fkernel.flash_attention_bwd_kernel(q, k, v, out, dout,
                                                       lse, **mode)
            check(all(torch.equal(x, y) for x, y in zip(again, got)),
                  f"{label}: two launches gave different gradients")
            if kv is not None:
                kp, vp = k.clone(), v.clone()
                kp[:, kv:], vp[:, kv:] = float("nan"), float("nan")
                out_p, lse_p = fkernel.flash_attention_kernel(
                    q, kp, vp, with_lse=True, **mode)
                dq, dk, dv = fkernel.flash_attention_bwd_kernel(
                    q, kp, vp, out_p, dout, lse_p, **mode)
                check(torch.equal(out_p, out) and torch.equal(lse_p, lse)
                      and torch.equal(dq, got[0])
                      and torch.equal(dk[:, :kv], got[1][:, :kv])
                      and torch.equal(dv[:, :kv], got[2][:, :kv]),
                      f"{label}: NaN past the key bound changed an output")
                check(not dk[:, kv:].any() and not dv[:, kv:].any(),
                      f"{label}: a key past the bound got a gradient")
        b, sq, sk, hq, hkv, d, causal, window, kv = TRAIN_BWD[0]
        leaves = [rand(b, sq, hq, d), rand(b, sk, hkv, d),
                  rand(b, sk, hkv, d)]
        dout = rand(b, sq, hq, d)
        n0 = (fops.flash_attention.launches,
              fops.flash_attention_bwd.launches)
        got = torch.autograd.grad(fops.flash_attention(
            *(t.requires_grad_() for t in leaves), causal=True), leaves,
            dout)
        check((fops.flash_attention.launches,
               fops.flash_attention_bwd.launches) == (n0[0] + 1, n0[1] + 1),
              f"the {dname} autograd call did not launch the forward and "
              f"backward once")
        want = torch.autograd.grad(fref.flash_attention_ref(
            *leaves, causal=True), leaves, dout)
        for name, g, w in zip(("autograd dq", "autograd dk", "autograd dv"),
                              got, want):
            check(g.dtype == dtype, f"{dname} autograd {name} is {g.dtype}")
            held(f"flash at {TRAIN_ARCH}'s call", name, g, w)
    log(f"phase 23 (a): the flash forward (out, lse) and the backward "
        f"kernel held against their plain versions in f32 and bf16 at "
        f"{len(TRAIN_BWD)} calls {TRAIN_BWD} (max abs err over each "
        f"output's largest magnitude "
        f"{json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})}; "
        f"tol {TRAIN_TOLS}, lse {TRAIN_TOL}); two launches bit-equal; NaN "
        f"past a key bound changed no bit and left those keys' dk and dv "
        f"zero; the autograd wrapper launched each kernel once in both "
        f"dtypes")
    return errs


def train_launches(cfg, steps):
    """The kernel launches of ``steps`` train steps of ``cfg`` on the
    card: a layer's attention and its SSM scan each run their forward
    twice a step (the remat recomputes each block in the backward pass)
    and their backward once."""
    attends = cfg.family != "ssm" and not cfg.uses_mla
    scans = cfg.ssm is not None and cfg.family in ("ssm", "hybrid")
    n = cfg.num_layers * steps
    return {"flash_attention": 2 * n * attends,
            "flash_attention_bwd": n * attends,
            "ssd_scan": 2 * n * scans, "ssd_scan_bwd": n * scans}


@contextlib.contextmanager
def plain_versions_on_card():
    """The models' attention and SSD scan through their plain versions,
    on whatever device the tensors are (the wrappers refuse that: a CUDA
    tensor launches the kernel or raises): the baseline of a hold that
    isolates the kernels from the card's other f32 arithmetic."""
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.ssd_scan import ref as sref
    from repro_torch.models import attention, ssm
    saved = attention.flash_attention, ssm.ssd_scan
    attention.flash_attention = fref.flash_attention_ref
    ssm.ssd_scan = sref.ssd_chunked_ref
    try:
        yield
    finally:
        attention.flash_attention, ssm.ssd_scan = saved


def train_two_layer_steps(torch, fops, label, runs, arch=TRAIN_ARCH,
                          sops=None, seed=0):
    """One train step of ``arch`` (smollm-135m by default) at full width
    cut to ``TRAIN_CPU_LAYERS`` layers, on the same weights (drawn on the
    CPU from ``seed``) and the trainer's first batch (its data seed
    ``seed``), for each (device, the weights' dtype, the activations'
    dtype, plain) of ``runs``; activations None take ``make_train_step``'s
    default (bf16); a plain run goes under :func:`plain_versions_on_card`.
    Each step on the card must launch the kernels as
    :func:`train_launches` says (the flash wrappers', and the scan's
    where ``sops`` is given; none in a plain run).  Returns ({name: the
    step's metrics and host s}, {name: {leaf: its gradient in f64 on the
    CPU}}), each run named "<device>[ plain] <activations' dtype>"."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as O
    from repro_torch.train import trainer as T
    from repro_torch.train.checkpoint import flatten_tree
    from repro_torch.train.data import DataConfig, batches
    cfg = dataclasses.replace(get_config(arch), num_layers=TRAIN_CPU_LAYERS)
    opt = O.AdamWConfig(total_steps=TRAIN_STEPS)
    raw = next(batches(cfg, DataConfig(seed=seed)))
    params = M.init_params(cfg, seed=seed, device="cpu")
    mods = (fops,) if sops is None else (fops, sops)
    metrics, grads = {}, {}
    for dev, wdt, adt, plain in runs:
        ctx = plain_versions_on_card if plain else contextlib.nullcontext
        p = O.tree_map(lambda t: t.to(dev, wdt), params)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
        step = (T.make_train_step(cfg, opt) if adt is None else
                T.make_train_step(cfg, opt, act_dtype=adt))
        adt = adt or torch.bfloat16
        for mod in mods:
            mod.reset_counts()
        t0 = time.perf_counter()
        with ctx():
            _, _, m = step(p, O.init(opt, p), batch)
        name = (f"{dev}{' plain' if plain else ''} "
                f"{str(adt).rsplit('.', 1)[-1]}")
        metrics[name] = T.read_metrics(m)
        metrics[name]["s"] = round(time.perf_counter() - t0, 2)
        if dev == "cuda":
            got = {fn.__name__: fn.launches for mod in mods
                   for fn in mod.KERNELS}
            want = {k: v * (not plain) for k, v in
                    train_launches(cfg, 1).items() if k in got}
            check(got == want, f"{label}: launches {got}, not {want}")
        p = O.tree_map(lambda t: t.detach().requires_grad_(True), p)
        with ctx():
            loss = M.loss_fn(p, cfg, batch, act_dtype=adt)[0]
            g = iter(torch.autograd.grad(loss, O.tree_leaves(p)))
        grads[name] = {k: v.double().cpu() for k, v in flatten_tree(
            O.tree_map(lambda _: next(g), p)).items()}
    return metrics, grads


def train_f32_runs(torch, card_plain):
    """The runs of :func:`train_cpu_check`: the CPU in f64 and f32, the
    card in f32, and with ``card_plain`` the card in f32 through the
    plain versions."""
    f32, f64 = torch.float32, torch.float64
    return ([("cpu", f64, f64, False), ("cpu", f32, f32, False),
             ("cuda", f32, f32, False)]
            + [("cuda", f32, f32, True)] * card_plain)


def train_f32_hold(metrics, grads, arch, label, base, factor):
    """The hold of :func:`train_cpu_check` on the runs of
    :func:`train_f32_runs`: loss and lr within ``TRAIN_TOL`` of their
    scale, card against CPU f32; the card's f32 grad norm no farther from
    the CPU's f64 run than ``factor`` times the yardstick run ``base``,
    and each gradient leaf (its largest absolute error over its largest
    f64 magnitude) no farther than ``factor`` times ``base``'s, or within
    ``TRAIN_TOL``.  Every leaf is logged before the checks, which name
    all the leaves that fail.  Returns the largest ratio of the card's
    error to ``base``'s over the grad norm and the leaves above
    ``TRAIN_TOL``, and where it was."""
    card, cpu, exact = (metrics[k] for k in ("cuda float32", "cpu float32",
                                             "cpu float64"))
    for key in ("loss", "lr"):
        check(abs(card[key] - cpu[key]) <= TRAIN_TOL * max(1.0,
                                                           abs(cpu[key])),
              f"{label}: {key} on the card {card[key]}, on the CPU "
              f"{cpu[key]}")
    card_err = abs(card["grad_norm"] - exact["grad_norm"])
    cpu_err = abs(cpu["grad_norm"] - exact["grad_norm"])
    base_err = abs(metrics[base]["grad_norm"] - exact["grad_norm"])
    g64 = grads["cpu float64"]
    check(sorted(grads["cuda float32"]) == sorted(g64),
          f"{label}: the card's gradient tree has other leaves")
    names = ["cuda float32", "cpu float32"] + [base] * (base != "cpu float32")
    leaf_errs, bad = {}, []
    worst = (card_err / max(base_err, 1e-300), "grad_norm")
    for k, w in g64.items():
        scale = w.abs().max().item()
        errs = [(grads[n][k] - w).abs().max().item() / scale for n in names]
        ec, eb = errs[0], errs[names.index(base)]
        leaf_errs[k] = [float(f"{e:.3e}") for e in errs]
        if ec > TRAIN_TOL:
            worst = max(worst, (ec / max(eb, 1e-300), k))
        if ec > max(TRAIN_TOL, factor * eb):
            bad.append(f"{k} (scale {scale:.4g})")
    log(f"{label}: {arch} at full width cut to "
        f"{TRAIN_CPU_LAYERS} layers, one train step on the same weights and "
        f"batch (B 8, S 256, TF32 off): {json.dumps(metrics)}; loss and lr "
        f"within {TRAIN_TOL} of scale, card against CPU f32; grad norm "
        f"from the CPU's f64 run: card f32 {card_err:.3e} "
        f"({card_err / exact['grad_norm']:.2e} of it), CPU f32 "
        f"{cpu_err:.3e} ({cpu_err / exact['grad_norm']:.2e})"
        + (f", {base} {base_err:.3e}" if base != "cpu float32" else "")
        + f"; each gradient leaf's largest error from the CPU's f64 run "
        f"over the leaf's largest magnitude, ({', '.join(names)}): "
        + json.dumps(leaf_errs) + f"; the card's largest ratio to {base} "
        f"(grad norm, leaves above {TRAIN_TOL}): {worst[0]:.3f} at "
        f"{worst[1]}")
    check(card_err <= factor * base_err,
          f"{label}: the card's f32 grad norm is {card_err:.3e} from the "
          f"CPU's f64 run, {factor}x {base}'s {factor * base_err:.3e}")
    check(not bad, f"{label}: gradient leaves {bad} on the card are farther "
          f"from the CPU's f64 run than {factor}x {base}'s")
    return worst


def train_cpu_check(torch, fops, arch=TRAIN_ARCH, sops=None,
                    label="phase 23 (b)", card_plain=False):
    """Phase 23 (b) (and phase 24 (b) for ``arch``, with the scan's
    counts from ``sops``): :func:`train_two_layer_steps` in f32 on the
    card (kernels) and on the CPU (plain versions) in f32 and in f64,
    held by :func:`train_f32_hold`.  The gradient is held against the
    f64 run: at this init the embedding's gradient passes layer 0's RMS
    norm of rows of scale 1/sqrt(49,152), which multiplies it by ~220
    and cancels most of it, so two f32 runs that sum in different orders
    differ by ~1e-3 of the grad norm (the CPU f32 run lands 7.41e-4 from
    the f64 one).  Phase 23's yardstick is the CPU's f32 run at factor 1.

    With ``card_plain`` (phase 24) the step also runs on the card through
    the plain versions (:func:`plain_versions_on_card`), and that run is
    the yardstick, at ``TRAIN_F32_FACTOR``: the card's other f32
    arithmetic (cuBLAS f32 GEMMs and the elementwise passes, which sum in
    other orders than the CPU's) is the baseline, and the hold measures
    what the kernels add.  hymba-1.5b's gradient at this init is
    ill-conditioned enough (the CPU's f32 leaves 0.5-2.6% of scale from
    f64) that the card with no kernel at all lands 2.0x the CPU's f32
    distance on the grad norm.  Returns the step's metrics."""
    metrics, grads = train_two_layer_steps(
        torch, fops, label, train_f32_runs(torch, card_plain), arch=arch,
        sops=sops)
    base, factor = (("cuda plain float32", TRAIN_F32_FACTOR) if card_plain
                    else ("cpu float32", 1.0))
    train_f32_hold(metrics, grads, arch, label, base, factor)
    return metrics


def train_bf16_cpu_check(torch, fops):
    """Phase 23 (e), its hold: :func:`train_two_layer_steps` at
    ``make_train_step``'s default activations (bf16; the weights f32,
    cast inside the loss) on the card (kernels) and on the CPU (plain
    versions), beside the CPU's f32 step.  Each gradient leaf's largest
    error on the card from the CPU's bf16 step, and the loss's and the
    grad norm's, must be no more than ``TRAIN_BF16_FACTOR`` times the
    CPU's bf16 step's distance from its f32 step: bf16 rounding sets how
    far two bf16 runs may part."""
    f32 = torch.float32
    metrics, grads = train_two_layer_steps(
        torch, fops, "phase 23 (e)",
        [("cpu", f32, f32, False), ("cpu", f32, None, False),
         ("cuda", f32, None, False)])
    card, cpu, cpu32 = (metrics[k] for k in ("cuda bfloat16",
                                             "cpu bfloat16", "cpu float32"))
    for key in ("loss", "grad_norm"):
        ec, ep = abs(card[key] - cpu[key]), abs(cpu[key] - cpu32[key])
        check(ec <= TRAIN_BF16_FACTOR * ep,
              f"phase 23 (e): bf16 {key} on the card {card[key]}, on the "
              f"CPU {cpu[key]} ({ec:.3e} apart), CPU f32 {cpu32[key]} "
              f"({ep:.3e} from the CPU's bf16)")
    c16, p16, p32 = (grads[k] for k in ("cuda bfloat16", "cpu bfloat16",
                                        "cpu float32"))
    check(sorted(c16) == sorted(p16), "phase 23 (e): the card's gradient "
          "tree has other leaves")
    leaf_errs = {}
    for k, w in p16.items():
        scale = w.abs().max().item()
        ec = (c16[k] - w).abs().max().item() / scale
        ep = (p32[k] - w).abs().max().item() / scale
        leaf_errs[k] = (float(f"{ec:.3e}"), float(f"{ep:.3e}"))
        check(ec <= TRAIN_BF16_FACTOR * ep,
              f"phase 23 (e): bf16 gradient leaf {k} on the card is "
              f"{ec:.3e} of its scale {scale:.4g} from the CPU's bf16 "
              f"step, which is {ep:.3e} from the CPU's f32 step")
    log(f"phase 23 (e) hold: {TRAIN_ARCH} at full width cut to "
        f"{TRAIN_CPU_LAYERS} layers, one bf16 train step on the same "
        f"weights and batch, card against CPU: {json.dumps(metrics)}; each "
        f"gradient leaf's largest error over its largest magnitude, (card "
        f"bf16 from CPU bf16, CPU f32 from CPU bf16), held at "
        f"{TRAIN_BF16_FACTOR}x the second: {json.dumps(leaf_errs)}")
    return metrics


def train_step_profile(torch, cfg, params, batch, dtype, phase=23):
    """Where a full-width train step's card time goes, activations in
    ``dtype``: one warm step, then CUDA events around the loss and its
    gradient and around the AdamW update, and a profile of one more
    step: device time of the flash forward (``flash_mma_kernel`` in f32,
    ``flash_tc_kernel`` in bf16), the backward kernels (``flash_bwd``),
    the scan's forward (``ssd_cb_kernel``, ``ssd_scan_kernel``) and
    backward (``ssd_bwd``), the GEMMs (kernels named ``gemm`` or
    ``nvjet``) and the rest.  Fails if a kernel that the config's step
    launches (:func:`train_launches`) has no device time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as O
    opt = O.AdamWConfig(total_steps=TRAIN_STEPS)
    state = O.init(opt, params)
    dname = str(dtype).rsplit(".", 1)[-1]

    def step():
        p = O.tree_map(lambda t: t.detach().requires_grad_(True), params)
        leaves = O.tree_leaves(p)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        loss, _ = M.loss_fn(p, cfg, batch, act_dtype=dtype)
        grads = iter(torch.autograd.grad(loss, leaves))
        ev[1].record()
        with torch.no_grad():
            O.update(opt, O.tree_map(lambda _: next(grads), p), state,
                     params)
        ev[2].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])

    step()
    fwd_bwd, update = step()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
    dev = lambda e: (getattr(e, "self_device_time_total", None)
                     or getattr(e, "self_cuda_time_total", 0))
    parts = {"flash forward": 0.0, "flash backward": 0.0,
             "scan forward": 0.0, "scan backward": 0.0, "gemm": 0.0,
             "other": 0.0}
    for e in prof.key_averages():
        key = e.key.lower()
        part = ("flash backward" if "flash_bwd" in key else
                "flash forward" if ("flash_mma_kernel" in key
                                    or "flash_tc_kernel" in key) else
                "scan backward" if "ssd_bwd" in key else
                "scan forward" if ("ssd_cb_kernel" in key
                                   or "ssd_scan_kernel" in key) else
                "gemm" if ("gemm" in key or "nvjet" in key) else "other")
        parts[part] += dev(e) / 1e3
    busy = sum(parts.values())
    runs = train_launches(cfg, 1)
    for part, name in (("flash forward", "flash_attention"),
                       ("flash backward", "flash_attention_bwd"),
                       ("scan forward", "ssd_scan"),
                       ("scan backward", "ssd_scan_bwd")):
        check(parts[part] > 0 or not runs[name],
              f"the profile attributed no {part} kernel: {parts}")
    top = sorted(prof.key_averages(), key=dev, reverse=True)[:8]
    log(f"phase {phase} train step breakdown ({cfg.name}, B 8, S 256, "
        f"{dname}): loss and gradient {fwd_bwd:.2f} ms, AdamW update "
        f"{update:.2f} ms (CUDA events); profiled step device busy "
        f"{busy:.2f} ms: "
        + json.dumps({k: round(v, 3) for k, v in parts.items()})
        + "; top kernels: " + "; ".join(
            f"{e.key[:60]} {dev(e) / 1e3:.3f} ms" for e in top))
    return {"fwd_bwd_ms": fwd_bwd, "update_ms": update, "busy_ms": busy,
            **{f"{k}_ms": v for k, v in parts.items()}}


def time_train_kernels(torch, fops, fref, spin):
    """The flash forward with its log-sum-exp and the backward kernel at
    smollm-135m's training call (``TRAIN_BWD[0]``), in f32 and bf16,
    each against its plain version and SDPA (autograd of
    ``scaled_dot_product_attention`` with ``is_causal``, K and V
    repeated to the query heads outside the timing: its forward, and its
    backward from a saved graph).  Bounds: inputs read and outputs
    written once (the backward: q, k, v, out, dout, lse in, dq, dk, dv
    out; the forward: q, k, v in, out and lse out), or the products
    over the causal pairs (2 D operations each a pair and query head:
    five in the backward, two in the forward) at the rate the kernel
    computes them: bf16 at 989 TFLOP/s, f32 in 3xTF32 at 495 / 3, each
    f32 one also at the CUDA cores' 67 for reference.  Returns the f32
    backward's kernels-line row."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fkernel
    b, sq, sk, hq, hkv, d, causal, _, _ = TRAIN_BWD[0]
    pairs = b * hq * sq * (sq + 1) // 2
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).rsplit(".", 1)[-1]
        gen = torch.Generator(device="cuda").manual_seed(230)
        rand = lambda *shape: torch.randn(*shape, generator=gen,
                                          device="cuda").to(dtype)
        q, dout = rand(b, sq, hq, d), rand(b, sq, hq, d)
        k, v = rand(b, sk, hkv, d), rand(b, sk, hkv, d)
        out, lse = fkernel.flash_attention_kernel(q, k, v, causal=True,
                                                  with_lse=True)
        fwd = lambda r: fkernel.flash_attention_kernel(q, k, v, causal=True,
                                                       with_lse=True)
        fwd_plain = lambda r: fref.flash_attention_ref(q, k, v, causal=True,
                                                       with_lse=True)
        bwd = lambda r: fkernel.flash_attention_bwd_kernel(
            q, k, v, out, dout, lse, causal=True)
        bwd_plain = lambda r: fref.flash_attention_bwd_ref(
            q, k, v, out, dout, lse, causal=True)
        err = hold(torch, f"flash backward {dname} dq", bwd(0)[0],
                   bwd_plain(0)[0], tol=TRAIN_TOLS[dname], floor=0.0)[0]
        qt = q.transpose(1, 2).contiguous().requires_grad_()
        kt, vt = (x.transpose(1, 2).repeat_interleave(hq // hkv, 1)
                  .contiguous().requires_grad_() for x in (k, v))
        lib_fwd = lambda r: F.scaled_dot_product_attention(qt, kt, vt,
                                                           is_causal=True)
        ot = lib_fwd(0)
        dot = dout.transpose(1, 2).contiguous()
        lib_bwd = lambda r: torch.autograd.grad(ot, (qt, kt, vt), dot,
                                                retain_graph=True)
        lib_bwd(0)
        size = q.element_size()
        nbytes = {"bwd": size * (4 * q.numel() + 4 * k.numel())
                  + 4 * lse.numel(),
                  "fwd": size * (2 * q.numel() + 2 * k.numel())
                  + 4 * lse.numel()}
        flops = {"bwd": 10 * d * pairs, "fwd": 4 * d * pairs}
        for part, fn, plain, lib in (("fwd", fwd, fwd_plain, lib_fwd),
                                     ("bwd", bwd, bwd_plain, lib_bwd)):
            t_bytes = nbytes[part] / HBM_BYTES_PER_S * 1e3
            t_ops = (flops[part] / BF16_FLOPS * 1e3 if dtype == torch.bfloat16
                     else 3 * flops[part] / TF32_FLOPS * 1e3)
            rows[f"{dname} {part}"] = {
                "ms": median_ms(torch, fn, TRAIN_REPS, spin),
                "plain_ms": median_ms(torch, plain, TRAIN_REPS, spin),
                "library_ms": median_ms(torch, lib, TRAIN_REPS, spin),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes_ms": t_bytes, "ops_ms": t_ops,
                "f32_cores_ms": flops[part] / F32_FLOPS * 1e3,
                "MB": nbytes[part] / 1e6, "GFLOP": flops[part] / 1e9}
        rows[f"{dname} bwd"]["max_abs_err"] = err
    log(f"time flash forward (with lse) and backward at {TRAIN_ARCH}'s call "
        f"(B {b}, S {sq}, {hq}/{hkv} heads of {d}, causal; median of "
        f"{TRAIN_REPS} CUDA-event times, ms; library: SDPA's forward, or "
        f"its backward; ops_ms at the rate the kernel computes: bf16 989 "
        f"TFLOP/s, f32 3xTF32 495 / 3; f32_cores_ms at the f32 CUDA "
        f"cores' 67): " + json.dumps({
            name: {k: (float(f"{x:.4g}") if isinstance(x, float) else x)
                   for k, x in row.items()} for name, row in rows.items()}))
    row = dict(rows["float32 bwd"])
    for key in ("bytes_ms", "ops_ms", "f32_cores_ms", "MB", "GFLOP"):
        row.pop(key)
    return row


def train_run(torch, np, cfg, label, run, dtype, reset_counts, counts):
    """``run()`` trains ``cfg`` uncut for ``TRAIN_STEPS`` steps (logging
    every step), counts zeroed just before and read just after: the
    launches of :func:`train_launches` (smollm-135m: the flash forward
    60 times a step, 30 layers each recomputed by the remat, the
    backward 30), nothing else and no plain call; every
    logged loss finite, and the first batch's loss (activations in
    ``dtype``) under the trained weights below its first-step loss.
    Logged: tokens/s, step ms, peak memory.  Returns (the trained
    params, the first batch, the launches)."""
    from repro_torch.models import model as M
    from repro_torch.train.data import DataConfig, batches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = counts("launches"), counts("plain_calls")
    peak = torch.cuda.max_memory_allocated()
    want = {name: 0 for name in launches}
    want.update(train_launches(cfg, TRAIN_STEPS))
    check(launches == want, f"{label} launches {launches}, not {want}")
    check(not any(plain.values()), f"plain versions ran in {label}: "
          f"{plain}")
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    check(len(hist) == TRAIN_STEPS and all(np.isfinite(losses)),
          f"{label} losses {losses}")
    dc = DataConfig()
    first = {k: torch.from_numpy(v).cuda()
             for k, v in next(batches(cfg, dc)).items()}
    with torch.no_grad():
        after = M.loss_fn(out["params"], cfg, first,
                          act_dtype=dtype)[0].item()
    check(after < losses[0], f"{label}: the first batch's loss {after} "
          f"after {TRAIN_STEPS} steps is not below its first-step loss "
          f"{losses[0]}")
    walls = [h["wall"] for h in hist]
    steps_ms = [(b - a) * 1e3 for a, b in zip(walls, walls[1:])]
    tokens = dc.batch_size * dc.seq_len
    tok_s = tokens * (TRAIN_STEPS - 1) / (walls[-1] - walls[0])
    log(f"{label}: {TRAIN_STEPS} steps in {wall:.2f} s (first step "
        f"{walls[0] * 1e3:.1f} ms); step ms after the first (host clock, "
        f"each ending in its metrics' readback) median "
        f"{statistics.median(steps_ms):.2f}, range {min(steps_ms):.2f}-"
        f"{max(steps_ms):.2f}; {tok_s:.0f} tokens/s; peak memory "
        f"{peak / 2 ** 30:.2f} GiB; losses {[round(x, 4) for x in losses]};"
        f" the first batch's loss {losses[0]:.4f} -> {after:.4f}; "
        f"launches {launches}")
    return out.pop("params"), first, launches


def train_phase(torch, np, fops, fref, spin, reset_counts, counts):
    """Phase 23: training.  (a) :func:`train_kernel_checks`; (b)
    :func:`train_cpu_check`; (c) ``repro_torch.launch.train.main`` on
    smollm-135m at full width (30 layers, d_model 576, 9/3 heads of 64,
    d_ff 1536, vocab 49,152, tied) at the launcher's defaults (B 8, S
    256, f32, TF32 off) for ``TRAIN_STEPS`` steps, held by
    :func:`train_run`; (d) the kernels timed at smollm-135m's call in
    both dtypes and the f32 step's breakdown; (e) bf16 training:
    :func:`train_bf16_cpu_check`, then ``trainer.train`` on the same
    config uncut with ``act_dtype=torch.bfloat16`` on the card for
    ``TRAIN_STEPS`` steps (held by :func:`train_run`) and the bf16
    step's breakdown.  Returns (the f32 backward's kernels-line row, its
    launches in (c))."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.train import trainer as T
    train_kernel_checks(torch, fops, fref)
    train_cpu_check(torch, fops)
    torch.cuda.empty_cache()
    cfg = get_config(TRAIN_ARCH)
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
           cfg.head_dim, cfg.d_ff, cfg.padded_vocab, cfg.tie_embeddings,
           cfg.remat_mode)
          == (30, 576, 9, 3, 64, 1536, 49152, True, "full"),
          f"phase 23 does not train {TRAIN_ARCH} at full width")
    params, first, launches = train_run(
        torch, np, cfg, f"phase 23 (c): {TRAIN_ARCH} full width through "
        f"launch/train.py (f32)",
        lambda: launch_train.main(["--arch", TRAIN_ARCH, "--full",
                                   "--steps", str(TRAIN_STEPS),
                                   "--log-every", "1"]),
        torch.float32, reset_counts, counts)
    row = time_train_kernels(torch, fops, fref, spin)
    torch.cuda.empty_cache()
    train_step_profile(torch, cfg, params, first, torch.float32)
    del params
    torch.cuda.empty_cache()
    train_bf16_cpu_check(torch, fops)
    torch.cuda.empty_cache()
    params, first, _ = train_run(
        torch, np, cfg, f"phase 23 (e): {TRAIN_ARCH} full width through "
        f"trainer.train, bf16 activations",
        lambda: T.train(cfg, T.TrainConfig(steps=TRAIN_STEPS, log_every=1),
                        act_dtype=torch.bfloat16, device="cuda"),
        torch.bfloat16, reset_counts, counts)
    train_step_profile(torch, cfg, params, first, torch.bfloat16)
    del params
    torch.cuda.empty_cache()
    return row, launches


# ---------------------------------------------------------------------------
# phase 24: training the SSM and hybrid families (the scan's backward)
# ---------------------------------------------------------------------------

SSM_TRAIN_ARCHS = ("mamba2-780m", "hymba-1.5b")
# (B, S, H, P, N, chunk, the final state's gradient given): mamba2-780m's
# and hymba-1.5b's training calls at the launcher's B 8, S 256 (two
# chunks; the final state dropped, as forward_train drops it) first, then
# a ragged S at both widths, chunks of 64 with a ragged S, and ragged P
# and N, with the final state's gradient given
SCAN_BWD = [(8, 256, 48, 64, 128, 128, False),
            (8, 256, 25, 64, 16, 128, False),
            (2, 200, 48, 64, 128, 128, True),
            (3, 200, 25, 64, 16, 128, True),
            (2, 200, 3, 32, 16, 64, True),
            (1, 40, 2, 33, 18, 16, True)]
SCAN_BWD_NAMES = ("dx", "ddt", "da", "db", "dc")


def scan_bwd_inputs(torch, gen, b, s, h, p, n):
    """The scan's inputs (x, b, c unit normal, dt = softplus(normal), a =
    -exp(normal)), then dy and a final-state gradient, drawn on the
    card."""
    rand = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    args = [rand(b, s, h, p), torch.nn.functional.softplus(rand(b, s, h)),
            -torch.exp(rand(h)), rand(b, s, n), rand(b, s, n)]
    return args, rand(b, s, h, p), rand(b, h, p, n)


def hold_scan_bwd(torch, sref, label, got, args, dy, dstate, chunk):
    """The backward kernel's hold (tests/test_torch_ssd_scan.py's): each
    output within ``TRAIN_TOL`` of its largest magnitude of the plain
    version in f32, or no farther from the plain version's f64 run than
    the plain f32 version is (da sums long runs of both signs, where two
    f32 orders part by about that much).  Returns {output: its error
    over its scale} and the largest absolute error."""
    want = sref.ssd_scan_bwd_ref(*args, dy, dstate, chunk)
    exact = sref.ssd_scan_bwd_ref(
        *(t.double() for t in args), dy.double(),
        None if dstate is None else dstate.double(), chunk)
    errs, worst = {}, 0.0
    for name, g, w, e in zip(SCAN_BWD_NAMES, got, want, exact):
        check(torch.isfinite(g).all().item(), f"{label}: {name} not finite")
        scale = max(w.abs().max().item(), 1e-30)
        err = (g - w).abs().max().item()
        if err > TRAIN_TOL * scale:
            ek = (g.double() - e).abs().max().item()
            ep = (w.double() - e).abs().max().item()
            check(ek <= ep, f"{label}: {name} {err:.3e} from the plain f32 "
                  f"version at scale {scale:.4g}, and {ek:.3e} from its f64 "
                  f"run, where the plain f32 version is {ep:.3e}")
        errs[name] = err / scale
        worst = max(worst, err)
    return errs, worst


def scan_kernel_checks(torch, sops, sref):
    """Phase 24 (a): on ``SCAN_BWD``'s calls the forward's stored chunk
    states against the plain scan's final state of each chunk's prefix
    and its C.B^T scratch (3xTF32) on and below the diagonal against
    C.B^T in plain f32 (each ``SCAN_TOL`` of scale), the backward kernel
    (which reads both) held by
    :func:`hold_scan_bwd`, a second launch bit-equal; then the autograd
    wrapper at both training calls launches the forward and the backward
    once each, no plain call, its gradient held the same way.  Returns
    the largest error over scale of each output."""
    from repro_torch.kernels.ssd_scan import kernel as skernel
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(24)
    errs = {}

    def note(e):
        for k, v in e.items():
            errs[k] = max(errs.get(k, 0.0), v)

    for b, s, h, p, n, chunk, given in SCAN_BWD:
        args, dy, ds = scan_bwd_inputs(torch, gen, b, s, h, p, n)
        ds = ds if given else None
        label = (f"phase 24 (a) scan backward (B {b}, S {s}, H {h}, P {p}, "
                 f"N {n}, chunk {chunk}, dstate {'given' if given else 'None'})")
        cb = torch.empty(skernel.scratch_shape(b, s, chunk), device="cuda")
        _, _, states = skernel.ssd_scan_kernel(*args, chunk=chunk,
                                               scratch=cb, with_states=True)
        cl = min(chunk, s)
        for z in range(states.shape[1]):
            rows = min(cl, s - z * cl)
            bz, cz = (t[:, z * cl:z * cl + rows] for t in args[3:5])
            want = torch.tril(cz @ bz.transpose(1, 2))
            err = (torch.tril(cb[:, z, :rows, :rows]) - want).abs().max()
            check(err.item() <= SCAN_TOL * max(1.0, want.abs().max().item()),
                  f"{label}: chunk {z}'s C.B^T {err.item():.3e} off")
            want = (sref.ssd_chunked_ref(*(t[:, :z * cl] if t.dim() > 1
                                           else t for t in args), chunk)[1]
                    if z else torch.zeros_like(states[:, 0]))
            err = (states[:, z] - want).abs().max().item()
            check(err <= SCAN_TOL * max(1.0, want.abs().max().item()),
                  f"{label}: chunk {z}'s stored state {err:.3e} off")
        got = skernel.ssd_scan_bwd_kernel(*args, dy, states, cb, ds,
                                          chunk=chunk)
        note(hold_scan_bwd(torch, sref, label, got, args, dy, ds, chunk)[0])
        again = skernel.ssd_scan_bwd_kernel(*args, dy, states, cb, ds,
                                            chunk=chunk)
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"{label}: two launches gave different gradients")
    for b, s, h, p, n, chunk, _ in SCAN_BWD[:2]:
        args, dy, _ = scan_bwd_inputs(torch, gen, b, s, h, p, n)
        leaves = [t.clone().requires_grad_() for t in args]
        sops.reset_counts()
        got = torch.autograd.grad(sops.ssd_scan(*leaves, chunk)[0], leaves,
                                  dy)
        counts = (sops.ssd_scan.launches, sops.ssd_scan_bwd.launches,
                  sops.ssd_scan.plain_calls)
        check(counts == (1, 1, 0), f"phase 24 (a): the autograd call at H "
              f"{h}, N {n} gave (forward, backward, plain) {counts}")
        note(hold_scan_bwd(torch, sref, f"phase 24 (a) autograd at H {h}",
                           got, args, dy, None, chunk)[0])
    log(f"phase 24 (a): the scan's stored chunk states and C.B^T and its "
        f"backward kernel held against their plain versions at {len(SCAN_BWD)} "
        f"calls {SCAN_BWD} (max abs err over each output's largest "
        f"magnitude {json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})}; "
        f"tol {TRAIN_TOL}, or no farther from the plain f64 run than the "
        f"plain f32 one); two launches bit-equal; the autograd wrapper "
        f"launched the forward and the backward once at both training "
        f"calls")
    return errs


def scan_bwd_flops(b, s, h, p, n, chunk, dstate=False):
    """Operations of the scan's forward and of its gradient at these
    shapes, each product counted on its triangle and only where its
    operands can be nonzero: per row and chunk of r rows, r (r + 1) / 2
    pairs, G = C.B^T 2 N a pair (the forward's; the backward reads it).
    The forward, per head: 2 P a pair (intra), 2 r P N for the outgoing
    state, and 2 r P N for the inter term except in the first chunk,
    whose incoming state is zero.  The backward, per head: 2 P a pair
    for dW and for dx's intra term; 2 r P N each for dS.b and dS^T.x,
    except in the last chunk when no final-state gradient is given
    (``dstate``), where dS is zero; and, except in the first chunk, 2 r
    P N for S_in^T.dy and 2 r P N for the chain's (exp(cum) o DY)^T.C.
    S_in^T.dy serves dc's inter term and dcum's alike: dy_i.(S_in c_i)
    = c_i.(S_in^T dy_i), so C.S_in^T is not counted.  Once per row and
    chunk, 2 N a pair each for db's and dc's intra products (B and C are
    shared by the heads, so their dG are summed before those two).
    Returns (forward, backward, the pairs summed over rows and
    chunks)."""
    cl = min(chunk, s)
    nc = -(-s // cl)
    fwd = bwd = tri = 0
    for z in range(nc):
        r = min(cl, s - z * cl)
        pairs = r * (r + 1) // 2
        rpn = 2 * r * p * n
        ds_live = dstate or z < nc - 1
        fwd += 2 * pairs * n + h * (2 * pairs * p + rpn + rpn * (z > 0))
        bwd += 4 * pairs * n + h * (4 * pairs * p + 2 * rpn * ds_live
                                    + 2 * rpn * (z > 0))
        tri += pairs
    return b * fwd, b * bwd, b * tri


def kernel_split(torch, fn, calls=5):
    """{CUDA kernel: device ms a call} over ``calls`` calls ``fn(1)``,
    ``fn(2)``, ... under ``torch.profiler`` (the kernels one call
    launches, apart).  A window in which the profiler delivered no
    device event (seen late in a long process) is profiled again, with
    four times the calls, up to twice; {} if it never delivers one."""
    import re
    from torch.profiler import ProfilerActivity, profile

    def name(key):                # the function's name, template included
        m = re.search(r"(\w+(?:<[^<>()]*>)?)\(", key)
        return m.group(1) if m else key[:40]

    dev = lambda e: (getattr(e, "self_device_time_total", None)
                     or getattr(e, "self_cuda_time_total", 0))
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for r in range(calls):
                fn(r + 1)
            torch.cuda.synchronize()
        split = {name(e.key): dev(e) / 1e3 / calls
                 for e in prof.key_averages() if dev(e) > 0}
        if split:
            return split
        calls *= 4
    return {}


def time_scan_train(torch, sops, sref, spin):
    """The scan's forward with its state store and its backward at both
    training calls (``SCAN_BWD[:2]``), each beside its plain version
    (``ssd_chunked_ref``, ``ssd_scan_bwd_ref``).  Bounds: inputs read and
    outputs written once (the forward: x, dt, a, b, c in, y, the final
    state, the chunk states and C.B^T's lower triangle out; the
    backward: x, dy, dt, a, b, c, the chunk states and that triangle in,
    dx, ddt, da, db, dc out), or the operations of
    :func:`scan_bwd_flops` at the card's f32 rate, 3xTF32's 495 / 3
    TFLOP/s (the repo's f32 convention; f32_cores_ms at the CUDA cores'
    67 beside it).  Each part also carries its CUDA kernels' device ms a
    call (:func:`kernel_split`).  No library call computes either.
    Returns mamba2-780m's backward row for the kernels line."""
    from repro_torch.kernels.ssd_scan import kernel as skernel
    gen = torch.Generator(device="cuda").manual_seed(240)
    rows = {}
    for arch, (b, s, h, p, n, chunk, _) in zip(SSM_TRAIN_ARCHS,
                                               SCAN_BWD[:2]):
        args, dy, _ = scan_bwd_inputs(torch, gen, b, s, h, p, n)
        cb = torch.empty(skernel.scratch_shape(b, s, chunk), device="cuda")
        _, _, states = skernel.ssd_scan_kernel(*args, chunk=chunk,
                                               scratch=cb, with_states=True)
        got = skernel.ssd_scan_bwd_kernel(*args, dy, states, cb, chunk=chunk)
        err = hold_scan_bwd(torch, sref, f"time {arch}", got, args, dy, None,
                            chunk)[1]
        fwd = lambda r: skernel.ssd_scan_kernel(*args, chunk=chunk,
                                                with_states=True)
        fwd_plain = lambda r: sref.ssd_chunked_ref(*args, chunk)
        bwd = lambda r: skernel.ssd_scan_bwd_kernel(*args, dy, states, cb,
                                                    chunk=chunk)
        bwd_plain = lambda r: sref.ssd_scan_bwd_ref(*args, dy, None, chunk)
        ins = sum(t.numel() for t in args)
        f_ops, b_ops, tri = scan_bwd_flops(b, s, h, p, n, chunk)
        nbytes = {"fwd": 4 * (ins + dy.numel() + b * h * p * n
                              + states.numel() + tri),
                  "bwd": 4 * (2 * ins + dy.numel() + states.numel() + tri)}
        flops = {"fwd": f_ops, "bwd": b_ops}
        for part, fn, plain in (("fwd", fwd, fwd_plain),
                                ("bwd", bwd, bwd_plain)):
            t_bytes = nbytes[part] / HBM_BYTES_PER_S * 1e3
            t_ops = 3 * flops[part] / TF32_FLOPS * 1e3
            rows[f"{arch} {part}"] = {
                "ms": median_ms(torch, fn, TRAIN_REPS, spin),
                "plain_ms": median_ms(torch, plain, TRAIN_REPS, spin),
                "library_ms": None,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "bytes_ms": t_bytes, "ops_ms": t_ops,
                "f32_cores_ms": flops[part] / F32_FLOPS * 1e3,
                "MB": nbytes[part] / 1e6, "GFLOP": flops[part] / 1e9,
                "kernels_ms": kernel_split(torch, fn)}
        rows[f"{arch} bwd"]["max_abs_err"] = err
    log("phase 24 (e): the scan's forward (with its state store) and "
        "backward at the training calls (B 8, S 256; mamba2-780m H 48, P "
        "64, N 128; hymba-1.5b H 25, P 64, N 16; chunk 128; median of "
        f"{TRAIN_REPS} CUDA-event times, ms; ops_ms at 3xTF32's 495 / 3 "
        "TFLOP/s, f32_cores_ms at the f32 CUDA cores' 67; kernels_ms: "
        "each CUDA kernel's device ms a call, torch.profiler): "
        + json.dumps({name: {k: (float(f"{x:.4g}") if isinstance(x, float)
                                 else {kk: float(f"{xx:.4g}")
                                       for kk, xx in x.items()}
                                 if isinstance(x, dict) else x)
                             for k, x in row.items()}
                      for name, row in rows.items()}))
    row = dict(rows["mamba2-780m bwd"])
    for key in ("bytes_ms", "ops_ms", "f32_cores_ms", "MB", "GFLOP",
                "kernels_ms"):
        row.pop(key)
    return row


# (layers, d_model, SSM heads, P, d_state, chunk, attention heads, KV
# heads, head size, window, remat) of the uncut configs phase 24 trains
SSM_TRAIN_WIDTHS = {
    "mamba2-780m": (48, 1536, 48, 64, 128, 128, 0, 0, 64, None, "full"),
    "hymba-1.5b": (32, 1600, 25, 64, 16, 128, 25, 5, 64, 2048, "full")}


def ssm_train_phase(torch, np, fops, sops, sref, spin, reset_counts, counts):
    """Phase 24: training the SSM and hybrid families on the card.  (a)
    :func:`scan_kernel_checks`; (b) :func:`train_cpu_check` for
    mamba2-780m and hymba-1.5b at full width cut to 2 layers, against
    the card's step through the plain versions; (c)
    ``repro_torch.launch.train.main`` on both uncut at the launcher's
    defaults (B 8, S 256, f32, TF32 off) for ``TRAIN_STEPS`` steps, held
    by :func:`train_run` (mamba2: the scan's forward 960 times, its
    backward 480; hymba: 640 and 320, and flash's 640 and 320), each
    step's breakdown; (d) ``trainer.train`` on hymba-1.5b uncut with
    ``act_dtype=torch.bfloat16`` (the scan stays f32) for
    ``TRAIN_STEPS`` steps, held the same way; (e)
    :func:`time_scan_train`.  Returns (the backward's kernels-line row,
    its launches in (c), both models' runs summed)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.models.transformer import d_inner
    from repro_torch.train import trainer as T
    t0 = time.perf_counter()
    scan_kernel_checks(torch, sops, sref)
    for arch in SSM_TRAIN_ARCHS:
        train_cpu_check(torch, fops, arch=arch, sops=sops,
                        label=f"phase 24 (b) {arch}", card_plain=True)
        torch.cuda.empty_cache()
    bwd_launches = 0
    for arch in SSM_TRAIN_ARCHS:
        cfg = get_config(arch)
        s = cfg.ssm
        widths = (cfg.num_layers, cfg.d_model,
                  d_inner(cfg) // s.head_dim, s.head_dim, s.d_state,
                  s.chunk_size, cfg.num_heads, cfg.num_kv_heads,
                  cfg.head_dim, cfg.sliding_window,
                  cfg.remat_mode)
        check(widths == SSM_TRAIN_WIDTHS[arch],
              f"phase 24 does not train {arch} at full width: {widths}")
        params, first, launches = train_run(
            torch, np, cfg, f"phase 24 (c): {arch} full width through "
            f"launch/train.py (f32)",
            lambda: launch_train.main(["--arch", arch, "--full", "--steps",
                                       str(TRAIN_STEPS), "--log-every",
                                       "1"]),
            torch.float32, reset_counts, counts)
        bwd_launches += launches["ssd_scan_bwd"]
        torch.cuda.empty_cache()
        train_step_profile(torch, cfg, params, first, torch.float32,
                           phase=24)
        del params
        torch.cuda.empty_cache()
    cfg = get_config("hymba-1.5b")
    params, _, _ = train_run(
        torch, np, cfg, "phase 24 (d): hymba-1.5b full width through "
        "trainer.train, bf16 activations",
        lambda: T.train(cfg, T.TrainConfig(steps=TRAIN_STEPS, log_every=1),
                        act_dtype=torch.bfloat16, device="cuda"),
        torch.bfloat16, reset_counts, counts)
    del params
    torch.cuda.empty_cache()
    row = time_scan_train(torch, sops, sref, spin)
    log(f"phase 24: {time.perf_counter() - t0:.1f} s")
    return row, bwd_launches


# ---------------------------------------------------------------------------
# phase 6: timings at the serve's shapes
# ---------------------------------------------------------------------------

def spin_ms(torch):
    """The card's time for one spin of SPIN_CYCLES (median of 5)."""
    times = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(SPIN_CYCLES)
        z.record()
        z.synchronize()
        times.append(a.elapsed_time(z))
    return statistics.median(times)


def median_ms(torch, fn, reps, spin):
    """Median card time of one call over ``reps`` calls ``fn(1)``,
    ``fn(2)``, ..., from CUDA events recorded on either side of it.  Each
    call is queued behind a spin kernel of ``spin`` ms, so the card is
    still spinning while the host enqueues the call and the events time
    the card's work, not the Python launch.  A call whose enqueueing
    outlasted the spin is timed again behind a spin twice as long (up to
    8x: a plain version of many small launches can take longer to
    enqueue than one spin); the phase fails if that keeps happening."""
    times, tries, k = [], 0, 1
    while len(times) < reps:
        tries += 1
        check(tries <= 3 * reps, "the host kept outlasting the spin kernel")
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES * k)
        t0 = time.perf_counter()
        a.record()
        fn(1 + len(times))
        z.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        z.synchronize()
        if host_ms < 0.8 * spin * k:
            times.append(a.elapsed_time(z))
        else:
            k = min(2 * k, 8)
    return statistics.median(times)


def distinct_slots(tables, lens, bt):
    """Distinct (page, slot) positions that the rows' first ``lens``
    tokens occupy: a prefix page that several rows share counts once."""
    ids = set()
    for row, n in zip(tables.tolist(), lens.tolist()):
        ids.update(row[j // bt] * bt + j % bt for j in range(n))
    return len(ids)


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def hold(torch, name, out, want, tol=5e-2, floor=1.0):
    """Max abs error of the kernel against its plain version, held to
    ``tol`` of the output's own scale (its largest magnitude, at least
    ``floor``): bf16's 5e-2 by default (served K/V are not unit-size:
    random weights leave values of order 10, where one bf16 step is
    0.06)."""
    scale = max(floor, want.float().abs().max().item())
    err = (out.float() - want.float()).abs().max().item()
    check(torch.isfinite(out).all().item(), f"{name}: NaN at the serve's "
          f"inputs")
    check(err <= tol * scale, f"{name}: err {err} at scale {scale}, tol "
          f"{tol} of scale")
    return err, scale


def time_decode(torch, ops, ref, calls, K, V, spin):
    """Kernel 1 on each decode step of the serve (its layer-0 queries,
    tables and lengths).  Timed calls take the pools of successive
    layers, as the 28 layers of a step do, so no call finds the last
    one's pages in L2.  The library yardstick is SDPA on the step's pages
    gathered into a dense view up to its longest row."""
    import torch.nn.functional as F
    nl, _, bt, hkv, d = K.shape
    per = {k: [] for k in ("ms", "plain_ms", "library_ms", "bound")}
    errs = []
    for q, tables, lens in calls:
        b, hq, _ = q.shape
        check(hq == hkv, "the yardstick assumes the served model's MHA")
        kern = lambda r: ops.paged_decode_attention(
            q, K[r % nl], V[r % nl], tables, lens)
        plain = lambda r: ref.paged_decode_attention_ref(
            q, K[r % nl], V[r % nl], tables, lens)
        errs.append(hold(torch, "paged_decode_attention", kern(0),
                         plain(0)))
        per["ms"].append(median_ms(torch, kern, DECODE_REPS, spin))
        per["plain_ms"].append(median_ms(torch, plain, DECODE_REPS, spin))
        w = -(-int(lens.max()) // bt)
        dense = lambda P, l: (P[l % nl][tables[:, :w].long()]
                              .reshape(b, w * bt, hkv, d).transpose(1, 2)
                              .contiguous())
        views = [(dense(K, l), dense(V, l)) for l in range(3)]
        mask = (torch.arange(w * bt, device="cuda")[None, :]
                < lens[:, None])[:, None, None, :]
        q4 = q[:, :, None, :]
        lib = lambda r: F.scaled_dot_product_attention(
            q4, *views[r % 3], attn_mask=mask)
        lib(0)
        per["library_ms"].append(median_ms(torch, lib, DECODE_REPS, spin))
        del views
        e = q.element_size()
        n_pages = sum(-(-n // bt) for n in lens.tolist())
        nbytes = (2 * q.numel() * e
                  + 2 * distinct_slots(tables, lens, bt) * hkv * d * e
                  + n_pages * 4 + b * 4)
        per["bound"].append(bound(nbytes, 4 * d * hq * int(lens.sum())))
    return per, errs


def time_prefill(torch, ops, ref, calls, K, V, spin):
    """Kernel 2 on each admission wave of the serve (its layer-0 suffix
    q/K/V, attention tables and prefix and suffix lengths), with the
    pools rotating over the layers as in ``time_decode``.  The library
    yardstick is SDPA on the wave's prefix pages gathered and joined to
    its suffix K/V, with the same mask."""
    import torch.nn.functional as F
    nl, _, bt, hkv, d = K.shape
    per = {k: [] for k in ("ms", "plain_ms", "library_ms", "bound")}
    errs = []
    for q, ks, vs, tables, pl, sl in calls:
        b, s, hq, _ = q.shape
        kern = lambda r: ops.paged_prefix_prefill_attention(
            q, ks, vs, K[r % nl], V[r % nl], tables, pl, sl)
        plain = lambda r: ref.paged_prefix_prefill_attention_ref(
            q, ks, vs, K[r % nl], V[r % nl], tables, pl, sl)
        errs.append(hold(torch, "paged_prefix_prefill_attention", kern(0),
                         plain(0)))
        per["ms"].append(median_ms(torch, kern, PREFILL_REPS, spin))
        per["plain_ms"].append(median_ms(torch, plain, PREFILL_REPS, spin))
        pcap = tables.shape[1] * bt
        dense = lambda P, x, l: (torch.cat(
            [P[l % nl][tables.long()].reshape(b, pcap, hkv, d), x], 1)
            .transpose(1, 2).contiguous())
        views = [(dense(K, ks, l), dense(V, vs, l)) for l in range(3)]
        kv_idx = torch.arange(pcap + s, device="cuda")
        q_idx = torch.arange(s, device="cuda")
        mask = torch.where(
            kv_idx[None, None, :] < pcap,
            kv_idx[None, None, :] < pl[:, None, None],
            (kv_idx[None, None, :] - pcap <= q_idx[None, :, None])
            & (kv_idx[None, None, :] - pcap < sl[:, None, None]))[:, None]
        qt = q.transpose(1, 2)
        lib = lambda r: F.scaled_dot_product_attention(
            qt, *views[r % 3], attn_mask=mask)
        lib(0)
        per["library_ms"].append(median_ms(torch, lib, PREFILL_REPS, spin))
        del views
        e = q.element_size()
        plens, slens = pl.tolist(), [min(n, s) for n in sl.tolist()]
        # every query row, pad rows past suffix_lens included, attends
        # its prefix and the suffix keys k <= row, k < suffix_lens
        pairs = sum(s * p + n * (n + 1) // 2 + (s - n) * n
                    for p, n in zip(plens, slens))
        nbytes = (2 * q.numel() * e + 2 * sum(slens) * hkv * d * e
                  + 2 * distinct_slots(tables, pl, bt) * hkv * d * e
                  + sum(-(-p // bt) for p in plens) * 4 + 2 * b * 4)
        per["bound"].append(bound(nbytes, 4 * d * hq * pairs))
    return per, errs


# ---------------------------------------------------------------------------
# phases 7-8: the padded serve and its kernels
# ---------------------------------------------------------------------------

def dense_recorders(transformer, layers, window=None):
    """Recorders of the dense model's layer-0 attention inputs: every
    prefill (one per batch; causal, with the served model's ``window``)
    and every ``DECODE_SAMPLE``-th decode step of each batch, with the
    step's layer-0 cache cloned, up to ``KEEP_BYTES`` in all."""
    left = [KEEP_BYTES]

    def afford(*ts):
        n = sum(t.nbytes for t in ts)
        if n > left[0]:
            return False
        left[0] -= n
        return True

    def keep_prefill(q, k, v, *, causal=True, window=None, want=window):
        check(causal and window == want,
              f"the served model is causal with window {want}, not "
              f"{window}")
        decode.restart()                      # a new batch
        return (q, k, v) if afford(q, k, v) else None

    def keep_decode(q, kc, vc, lengths):
        if afford(kc, vc):
            return q[:, 0].clone(), kc.clone(), vc.clone(), lengths.clone()
        return None

    prefill = Recorder(transformer, "gqa_prefill_attention", layers,
                       keep_prefill)
    decode = Recorder(transformer, "gqa_decode_attention", layers,
                      keep_decode, every=DECODE_SAMPLE, snap=(0, 3))
    return prefill, decode


def check_captures(label, engine, results, rep, steps):
    """A padded serve captured its decode step once per batch of at least
    ``MIN_GRAPH_STEPS`` steps, and replayed every step of those batches
    but the first (the capture's warm-up step, run eagerly)."""
    from repro_torch.serving.engine import MIN_GRAPH_STEPS
    graphed = [r for r in results if r.iterations >= MIN_GRAPH_STEPS]
    check(engine.graph_captures == len(rep.captures) == len(graphed),
          f"{label}: {engine.graph_captures} captures for {len(graphed)} "
          f"batches of at least {MIN_GRAPH_STEPS} steps")
    check(rep.replayed_steps == sum(r.iterations - 1 for r in graphed),
          f"{label}: {rep.replayed_steps} replayed steps")
    rep.log(label, steps)


def profile_dense_window(torch, engine, reqs, bl, cache_len, steps=8,
                         label="padded", kernel="decode_split_kernel"):
    """Where a padded decode step's time goes on the card: prefill one
    batch of the serve's shape (its rows and lengths, random prompt ids)
    and copy its state; capture the decode step on the batch's state as
    ``serve_batch`` does (the warm-up step is the first step), and decode
    the copy eagerly with ``decode_multi``; hold the first ``steps``-step
    windows bit for bit (tokens, logits, positions, cache); then time and
    profile windows of ``steps`` steps through each (:func:`window_profile`:
    host ms, device busy ms and idle share a step, the readback
    included).  The vlm family's batch carries the engine's zero
    patches and the encoder-decoder family's its zero frames, as
    ``serve_batch`` feeds them.  Returns {"graphed": ..., "eager":
    ...}."""
    from repro_torch.models import model as M
    from repro_torch.serving.graphs import DecodeGraph
    cfg, params, dtype = engine.cfg, engine.params, engine.dtype
    gen = torch.Generator(device="cuda").manual_seed(3)
    lengths = torch.tensor([min(r.length, bl) for r in reqs],
                           dtype=torch.int32, device="cuda")
    tokens = torch.randint(3, cfg.vocab_size, (len(reqs), bl), generator=gen,
                           device="cuda", dtype=torch.int32)
    batch = engine._frontend({"tokens": tokens, "lengths": lengths},
                             len(reqs))
    logits, cache = M.prefill(params, cfg, batch, act_dtype=dtype,
                              cache_len=cache_len)
    eager = {"cache": {key: tuple(t.clone() for t in leaves)
                       for key, leaves in cache.items()},
             "logits": logits.clone(), "positions": lengths.clone()}

    def run_eager():
        e = eager
        e["logits"], e["cache"], e["positions"], toks = M.decode_multi(
            params, cfg, e["cache"], {"logits": e["logits"],
                                      "positions": e["positions"]},
            num_steps=steps, act_dtype=dtype)
        e["toks"] = toks.cpu()
        return steps

    graph = DecodeGraph.padded(params, cfg, cache, logits, lengths,
                               act_dtype=dtype, max_steps=steps,
                               stream=torch.cuda.Stream())
    toks = graph.window(steps, 1).cpu()
    run_eager()
    same = (torch.equal(toks, eager["toks"])
            and torch.equal(graph.state["logits"], eager["logits"])
            and torch.equal(graph.state["positions"], eager["positions"])
            and all(torch.equal(a, b) for key, leaves in cache.items()
                    for a, b in zip(leaves, eager["cache"][key])))
    check(same, f"{label}: graphed and eager windows differ")
    log(f"{label}: graphed and eager {steps}-step windows at {len(reqs)} "
        f"rows: tokens, logits, positions and cache bit-equal")

    def run_graphed():
        graph.window(steps).cpu()
        return steps

    where = f"decode window at {len(reqs)} rows, cache {cache_len}"
    return {"eager": window_profile(torch, run_eager,
                                    f"{label} eager {where}", kernel),
            "graphed": window_profile(torch, run_graphed,
                                      f"{label} graphed {where}", kernel)}


def log_profiles(label, profiles):
    log(f"{label}, graphed against eager: " + json.dumps(
        {mode: {key: round(v, 4) for key, v in m.items()}
         for mode, m in profiles.items()}))


def time_flash(torch, fops, fref, calls, spin, window=None, kv_len=None):
    """Kernel 3 on each batch's layer-0 prefill of the padded serve, as
    the model calls it: causal, with the served model's ``window``; or,
    given a key bound ``kv_len`` (the encoder-decoder family's encoder
    and cross attention), in full mode over the first ``kv_len`` keys.
    The library yardstick is SDPA on the same q, k, v in SDPA's [B, H,
    S, D] layout, K and V repeated to the query heads for GQA: with
    ``is_causal``, with a boolean mask of the band where the window is
    shorter than the sequence, or unmasked on K and V cut to the bound.
    The bound reads q and the K/V rows a query can see once and writes
    the output once."""
    import torch.nn.functional as F
    per = {k: [] for k in ("ms", "plain_ms", "library_ms", "bound")}
    errs = []
    causal = kv_len is None
    for q, k, v in calls:
        b, s, hq, d = q.shape
        g = hq // k.shape[2]
        kern = lambda r: fops.flash_attention(q, k, v, causal=causal,
                                              window=window, kv_len=kv_len)
        plain = lambda r: fref.flash_attention_ref(
            q, k, v, causal=causal, window=window, kv_len=kv_len)
        errs.append(hold(torch, "flash_attention", kern(0), plain(0)))
        per["ms"].append(median_ms(torch, kern, PREFILL_REPS, spin))
        per["plain_ms"].append(median_ms(torch, plain, PREFILL_REPS, spin))
        keys = k.shape[1] if causal else kv_len
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (x[:, :keys].transpose(1, 2).contiguous()
                  .repeat_interleave(g, 1) for x in (k, v))
        w = s if window is None else min(window, s)
        if not causal:
            lib = lambda r: F.scaled_dot_product_attention(qt, kt, vt)
        elif w < s:
            i = torch.arange(s, device="cuda")
            band = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < w)
            lib = lambda r: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=band)
        else:
            lib = lambda r: F.scaled_dot_product_attention(qt, kt, vt,
                                                           is_causal=True)
        lib(0)
        per["library_ms"].append(median_ms(torch, lib, PREFILL_REPS, spin))
        del qt, kt, vt
        e = q.element_size()
        # every (q, k) pair a query sees: k <= q and q - k < w, or every
        # key below the bound
        pairs = (b * s * kv_len if not causal
                 else b * (w * (w + 1) // 2 + (s - w) * w))
        nbytes = 2 * q.numel() * e + 2 * b * keys * k.shape[2] * d * e
        per["bound"].append(bound(nbytes, 4 * d * hq * pairs))
    return per, errs


def time_dense_decode(torch, dops, dref, calls, spin):
    """Kernel 4 on each kept decode step of the padded serve (its layer-0
    query, the cache as the step met it, and the lengths).  The library
    yardstick is SDPA with a length mask on the cache cut to its longest
    row, K and V repeated to the query heads for GQA."""
    import torch.nn.functional as F
    per = {k: [] for k in ("ms", "plain_ms", "library_ms", "bound")}
    errs = []
    for q, kc, vc, lens in calls:
        b, hq, d = q.shape
        _, s, hkv, _ = kc.shape
        kern = lambda r: dops.decode_attention(q, kc, vc, lens)
        plain = lambda r: dref.decode_attention_ref(q, kc, vc, lens)
        errs.append(hold(torch, "decode_attention", kern(0), plain(0)))
        per["ms"].append(median_ms(torch, kern, DECODE_REPS, spin))
        per["plain_ms"].append(median_ms(torch, plain, DECODE_REPS, spin))
        w = int(lens.max())
        kt, vt = (x[:, :w].transpose(1, 2).repeat_interleave(hq // hkv, 1)
                  .contiguous() for x in (kc, vc))
        mask = (torch.arange(w, device="cuda")[None, :]
                < lens[:, None])[:, None, None, :]
        q4 = q[:, :, None, :]
        lib = lambda r: F.scaled_dot_product_attention(q4, kt, vt,
                                                       attn_mask=mask)
        lib(0)
        per["library_ms"].append(median_ms(torch, lib, DECODE_REPS, spin))
        del kt, vt
        e = q.element_size()
        n_keys = int(lens.clamp(max=s).sum())
        nbytes = 2 * q.numel() * e + 2 * n_keys * hkv * d * e + b * 4
        per["bound"].append(bound(nbytes, 4 * d * hq * n_keys))
    return per, errs


def summarize(name, per, errs):
    """Mean over the serve's decode steps (or waves) of each median:
    every step or wave launches the kernel once per layer, so this is
    the mean time of one of the serve's launches.  A kernel that no
    single PyTorch call computes has no library time (null)."""
    mean = lambda xs: sum(xs) / len(xs)
    bound_by = {by for _, by in per["bound"]}
    row = {"ms": mean(per["ms"]), "plain_ms": mean(per["plain_ms"]),
           "library_ms": (mean(per["library_ms"]) if per["library_ms"]
                          else None),
           "bound_ms": mean([t for t, _ in per["bound"]]),
           "bound_by": bound_by.pop() if len(bound_by) == 1 else "bytes",
           "max_abs_err": max(e for e, _ in errs)}
    lib = ("none" if row["library_ms"] is None
           else f"{row['library_ms']:.4f}")
    log(f"time {name} over {len(errs)} served shapes (mean of per-shape "
        f"medians, CUDA events, ms): kernel {row['ms']:.4f} (shapes "
        f"{min(per['ms']):.4f}-{max(per['ms']):.4f}), plain "
        f"{row['plain_ms']:.4f}, library {lib}, bound "
        f"{row['bound_ms']:.4f} ({row['bound_by']}; by shape "
        f"{sorted({by for _, by in per['bound']})}); max abs err "
        f"{row['max_abs_err']:.3e} at output scale up to "
        f"{max(sc for _, sc in errs):.1f}")
    return row


# ---------------------------------------------------------------------------
# phases 9-13: the SSM family and the int8 decode cache
# ---------------------------------------------------------------------------

def scan_inputs(torch, b, s, h, p, n, gen):
    """The reference test's distributions: x, b, c unit normal, dt =
    softplus(normal) > 0, a = -exp(normal) < 0."""
    f = dict(device="cuda", generator=gen)
    x = torch.randn(b, s, h, p, **f)
    dt = torch.nn.functional.softplus(torch.randn(b, s, h, **f))
    a = -torch.exp(torch.randn(h, **f))
    return x, dt, a, torch.randn(b, s, n, **f), torch.randn(b, s, n, **f)


def scan_err(got, want):
    """(max abs error, output scale) of a scan's (y, state) pair."""
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    scale = max(w.abs().max().item() for w in want)
    return err, scale


def ssm_int8_kernel_checks(torch, sops, sref, dops, dref, quant):
    """The scan at mamba2-780m's shapes against both plain versions: the
    chunked one at 2e-4 of the output's scale (f32 in 3xTF32 on the
    tensor cores; the kernel sums the cumulative log-decay and the dot
    products in another order), the per-token recurrence at the
    reference's 5e-3; through the wrapper, then at each P slice, with the
    C.B^T scratch held against c @ b^T on its lower triangle at 2e-4 of
    its scale.  The int8 decode at chatglm-6b's heads (32/32, D 128) and
    a GQA shape (40/8), f32 and bf16 queries, caches quantised with the
    model's ``_quant_i8``; then int8 extremes and NaN and inf scales past
    every row's length, which must change nothing."""
    from repro_torch.kernels.ssd_scan import kernel as skernel
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(4)
    for b, s in ((1, 256), (8, 256), (1, 200), (8, 200)):
        args = scan_inputs(torch, b, s, 48, 64, 128, gen)
        n0 = sops.ssd_scan.launches
        outs = {"wrapper": sops.ssd_scan(*args, 128)}
        check(sops.ssd_scan.launches == n0 + 1, "ssd_scan did not launch")
        scratch = torch.full(skernel.scratch_shape(b, s, 128), float("nan"),
                             device="cuda")
        for pt in skernel.P_TILES:
            outs[f"P slice {pt}"] = skernel.ssd_scan_kernel(
                *args, chunk=128, p_tile=pt, scratch=scratch)
        chunked = sref.ssd_chunked_ref(*args, 128)
        naive = sref.ssd_scan_ref(*args)
        torch.cuda.synchronize()
        for how, out in outs.items():
            check(all(torch.isfinite(t).all().item() for t in out),
                  f"ssd_scan B={b} S={s} {how}: non-finite output")
            err, scale = scan_err(out, chunked)
            err_naive, _ = scan_err(out, naive)
            log(f"kernel ssd_scan mamba2-780m B={b} S={s} {how}: max_abs_err"
                f" {err:.3e} against the chunked version at scale "
                f"{scale:.1f} (tol {SCAN_TOL} of scale), {err_naive:.3e} "
                f"against the recurrence (tol 5e-3)")
            check(err <= SCAN_TOL * max(1.0, scale), f"ssd_scan B={b} S={s} "
                  f"{how}: err {err} at scale {scale}")
            check(err_naive <= 5e-3, f"ssd_scan B={b} S={s} {how}: err "
                  f"{err_naive} against the recurrence")
        bb, cc = args[3], args[4]
        for z in range(-(-s // 128)):
            m = min(128, s - z * 128)
            rows = slice(z * 128, z * 128 + m)
            want = torch.tril(cc[:, rows] @ bb[:, rows].transpose(1, 2))
            err = (torch.tril(scratch[:, z, :m, :m]) - want).abs().max().item()
            scale = want.abs().max().item()
            check(err <= SCAN_TOL * max(1.0, scale), f"ssd_scan B={b} S={s}: "
                  f"C.B^T scratch of chunk {z} err {err} at scale {scale}")
    tol = {torch.float32: 2e-4, torch.bfloat16: 5e-2}
    shapes = [("chatglm-6b", 16, 512, 32, 32, 128,       # b, s, hq, hkv, d
               cycle([1, 17, 31, 32, 33, 200, 511, 512], 16)),
              ("gqa 40/8", 8, 512, 40, 8, 128,
               [512, 13, 256, 1, 77, 300, 500, 64])]
    for dtype in (torch.float32, torch.bfloat16):
        for name, b, s, hq, hkv, d, lengths in shapes:
            q = torch.randn(b, hq, d, generator=gen, device="cuda").to(dtype)
            (kq, ks), (vq, vs) = (
                quant(torch.randn(b, s, hkv, d, generator=gen,
                                  device="cuda")) for _ in range(2))
            lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            out = dops.decode_attention_int8(q, kq, vq, ks, vs, lens)
            want = dref.decode_attention_int8_ref(q, kq, vq, ks, vs, lens)
            for i, n in enumerate(lengths):
                kq[i, n:], vq[i, n:] = 127, -128
                ks[i, n:], vs[i, n:] = float("nan"), float("inf")
            poisoned = dops.decode_attention_int8(q, kq, vq, ks, vs, lens)
            torch.cuda.synchronize()
            err = (out.float() - want.float()).abs().max().item()
            change = (poisoned.float() - out.float()).abs().max().item()
            log(f"kernel decode_attention_int8 {name} S={s} q {dtype}: "
                f"max_abs_err {err:.3e} (tol {tol[dtype]}); int8 extremes "
                f"and NaN/inf scales past the lengths change it by "
                f"{change:.3e}")
            check(torch.isfinite(out).all().item(), f"int8 {name}: NaN")
            check(err <= tol[dtype], f"int8 {name} {dtype}: err {err}")
            check(change == 0.0, f"int8 {name}: poison past the lengths "
                  f"changed the output by {change}")


def _rel_errs(torch, got, want):
    return [((a.cpu().float() - c.float()).abs().max()
             / (1 + c.float().abs().max())).item()
            for a, c in zip(got, want)]


def ssm_int8_model_checks(torch, np, quant):
    """Reduced mamba2-780m (padded prefill, then a fused decode window)
    and reduced chatglm-6b's fused decode on an int8 cache (the CPU
    prefill's cache quantised, the same int8 cache on both sides), in
    f32 on the card against the CPU: logits and caches at 2e-4 of scale,
    tokens equal."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.params import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(5)
    b, s, steps = 3, 32, 6
    lengths = np.array([32, 17, 5])
    cfg = get_config("mamba2-780m").reduced()
    params_cpu = init_params(cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu")
    tokens = rng.integers(3, cfg.vocab_size, size=(b, s))
    results = {}
    for dev in ("cpu", "cuda"):
        params = params_cpu if dev == "cpu" else _to(torch, params_cpu, dev)
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int32,
                                      device=dev)
        logits, cache = M.prefill(params, cfg, {"tokens": t(tokens),
                                                "lengths": t(lengths)},
                                  act_dtype=torch.float32)
        out = [logits.clone()] + [c.clone() for c in cache["ssm"]]
        logits, cache, _, toks = M.decode_multi(
            params, cfg, cache, {"logits": logits, "positions": t(lengths)},
            num_steps=steps, act_dtype=torch.float32)
        results[dev] = (out + [logits, *cache["ssm"]], toks.cpu())
    errs = _rel_errs(torch, results["cuda"][0], results["cpu"][0])
    same = torch.equal(results["cuda"][1], results["cpu"][1])
    log(f"model mamba2-780m reduced f32 card vs cpu: max rel err "
        f"{max(errs):.3e} (tol 2e-4) over prefill logits and state, the "
        f"logits and state after {steps} fused decode steps; tokens equal: "
        f"{same}")
    check(same, "mamba2 decode tokens differ between card and cpu")
    check(max(errs) <= 2e-4, f"mamba2 model card vs cpu: {errs}")

    cfg = get_config("chatglm-6b").reduced()
    cfg8 = dataclasses.replace(cfg, cache_int8=True)
    params_cpu = init_params(cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu")
    tokens = torch.as_tensor(rng.integers(3, cfg.vocab_size, size=(b, s)),
                             dtype=torch.int32)
    lens = torch.as_tensor(lengths, dtype=torch.int32)
    logits, fcache = M.prefill(params_cpu, cfg, {"tokens": tokens,
                                                 "lengths": lens},
                               act_dtype=torch.float32, cache_len=s + 16)
    (kq, ks), (vq, vs) = quant(fcache["kv"][0]), quant(fcache["kv"][1])
    results = {}
    for dev in ("cpu", "cuda"):
        params = params_cpu if dev == "cpu" else _to(torch, params_cpu, dev)
        cache = {"kv": tuple(x.to(dev, copy=True) for x in (kq, vq, ks, vs))}
        lg, cache, _, toks = M.decode_multi(
            params, cfg8, cache, {"logits": logits.to(dev),
                                  "positions": lens.to(dev)},
            num_steps=4, act_dtype=torch.float32)
        results[dev] = (lg.cpu(), [x.cpu() for x in cache["kv"]],
                        toks.cpu())
    (lg_g, c_g, t_g), (lg_c, c_c, t_c) = results["cuda"], results["cpu"]
    err = _rel_errs(torch, [lg_g], [lg_c])[0]
    i8 = max((a.int() - c.int()).abs().max().item()
             for a, c in zip(c_g[:2], c_c[:2]))
    sc = max(((a.float() - c.float()).abs() / c.float().abs().clamp(
        min=1e-30)).max().item() for a, c in zip(c_g[2:], c_c[2:]))
    log(f"model chatglm-6b reduced f32 int8-cache decode, card vs cpu: max "
        f"rel err {err:.3e} (tol 2e-4) over the logits after 4 fused steps;"
        f" new int8 values differ by at most {i8} (tol 1), scales by "
        f"{sc:.2e} relative (tol one bf16 step, 2**-7); tokens equal: "
        f"{torch.equal(t_g, t_c)}")
    check(torch.equal(t_g, t_c), "int8 decode tokens differ, card vs cpu")
    check(err <= 2e-4 and i8 <= 1 and sc <= 2 ** -7,
          f"int8 model card vs cpu: {err}, {i8}, {sc}")


def ssm_serve(torch, ssm_module, hbm, reset_counts, counts):
    """Phase 11: mamba2-780m at full width in bf16 through
    ``run_engine_backend`` (``magnus``, the padded ``BatchEngine``) on
    phase 7's 64 Poisson requests, with the launch counts zeroed just
    before and read just after.  Returns (the launch counts, the kept
    layer-0 scan inputs, one per batch, the serve's tokens/s and wall
    s)."""
    from repro_torch.launch.serve import run_engine_backend
    from repro_torch.configs import get_config
    reqs, targets = phase7_requests(get_config("mamba2-780m").vocab_size)
    t0 = time.perf_counter()
    with Recorder(ssm_module, "ssd_scan", 48) as scans, replays() as rep:
        reset_counts()
        res = run_engine_backend(
            "mamba2-780m", 0.0, 0.0, "magnus", seed=0, reduced=False,
            device="cuda", dtype=torch.bfloat16, hbm_bytes=hbm,
            max_len=DENSE_MAX_LEN, max_gen=DENSE_MAX_GEN, requests=reqs)
        launches = counts("launches")
    plain = counts("plain_calls")
    engine, results = res.pop("engine"), res.pop("results")
    log(f"SSM padded serve mamba2-780m full width bf16 magnus: "
        f"{time.perf_counter() - t0:.1f} s with set-up; " + json.dumps(res))
    log(f"SSM padded serve batches (size, batch length, G(B), host "
        f"syncs): " + "; ".join(
            f"({r.batch_size}, {r.batch_length}, {r.iterations}, "
            f"{bin(r.iterations).count('1')})" for r in results))
    log(f"SSM padded serve kernel launches {launches}, plain calls {plain}")
    cfg = engine.cfg
    check((cfg.num_layers, cfg.d_model, cfg.ssm.d_inner(cfg.d_model),
           cfg.ssm.n_heads(cfg.d_model), cfg.ssm.d_state,
           cfg.padded_vocab) == (48, 1536, 3072, 48, 128, 51200),
          "the SSM serve did not run mamba2-780m at full width")
    check_padded_serve("the SSM serve", cfg, res, results, targets)
    check(launches["ssd_scan"] == cfg.num_layers * len(results),
          f"ssd_scan launches {launches['ssd_scan']} != 48 x "
          f"{len(results)} batches")
    check(all(v == 0 for k, v in launches.items() if k != "ssd_scan"),
          f"the SSM serve launched an attention kernel: {launches}")
    check(not any(plain.values()), f"plain versions ran on the SSM path: "
          f"{plain}")
    check(len(scans.kept) == len(results),
          f"kept {len(scans.kept)} scans for {len(results)} batches")
    check_captures("SSM padded serve", engine, results, rep,
                   sum(r.iterations for r in results))
    big = max(results, key=lambda r: r.batch_size)
    log_profiles(f"SSM padded decode step at {big.batch_size} rows",
                 profile_dense_window(
                     torch, engine,
                     [r for r in reqs if r.req_id in big.generated],
                     big.batch_length, big.batch_length + big.iterations,
                     label="SSM padded", kernel=None))
    return launches, scans.kept, {k: res[k] for k in ("wall_s", "token_tp")}


def int8_window(torch, np, transformer, dref, reset_counts, counts):
    """Phase 12: the reference's test_perf_knobs procedure at full width.
    chatglm-6b in bf16, a dense prefill of INT8_ROWS 2,048-token prompts
    into a 2,112-slot cache, that cache quantised layer by layer with the
    model's ``_quant_i8`` into ``init_cache(cfg_int8)``, then a fused
    decode of INT8_STEPS steps (1 + 63, to read the first step's logits)
    on the bf16 cache with ``cfg`` and on the int8 cache with
    ``cfg_int8``.  Held: the launch counts of both windows, no plain
    call, finite logits and tokens in range.

    Witnesses decode the first step again on copies of the caches with
    the model's attention replaced by plain torch: the port's int8
    formulation (``decode_attention_int8_ref``, dequantised in f32), the
    reference model's (the cache dequantised into bf16, then the float
    decode attention) and, as a control, the bf16 window's own
    (``decode_attention_ref``).  With random weights at full width each
    head's softmax is nearly one-hot, so a change in the last bits of
    one layer moves the top key in a few heads of later ones, and the
    first step's logits move by several hundredths of their scale: the
    control measures that for the accepted bf16 kernel.  No bound in
    units of the scale holds there, not even the reference's own 0.05
    of float, so the distances are held against each other (distance =
    max over the logits, over the second one's scale):
    - the int8 window from its plain formulation at most 2x the bf16
      window from its own: the int8 kernel moves the model no more than
      the bf16 kernel does;
    - the int8 window from the bf16 window at most 1.25x the reference's
      formulation from it: the port's int8 decode is no further from
      float than the reference's;
    - the int8 window from the reference's formulation at most half its
      distance from the bf16 window: closer to the reference's int8
      decode than to float.
    Returns (the int8 launch counts, the kept calls)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cfg = get_config("chatglm-6b")
    cfg8 = dataclasses.replace(cfg, cache_int8=True)
    params = M.init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    rows, cl = INT8_ROWS, INT8_PROMPT + INT8_STEPS
    tokens = torch.as_tensor(rng.integers(3, cfg.vocab_size,
                                          size=(rows, INT8_PROMPT)),
                             dtype=torch.int32, device="cuda")
    lengths = torch.full((rows,), INT8_PROMPT, dtype=torch.int32,
                         device="cuda")
    t0 = time.perf_counter()
    logits, cache = M.prefill(params, cfg, {"tokens": tokens,
                                            "lengths": lengths},
                              act_dtype=torch.bfloat16, cache_len=cl)
    cache8 = M.init_cache(cfg8, rows, cl, device="cuda")
    k8, v8, ks8, vs8 = cache8["kv"]
    for i in range(cfg.num_layers):
        k8[i], ks8[i] = transformer._quant_i8(cache["kv"][0][i])
        v8[i], vs8[i] = transformer._quant_i8(cache["kv"][1][i])
    torch.cuda.synchronize()
    nbytes = lambda ts: sum(t.nbytes for t in ts)
    log(f"int8 window set-up: prefill of {rows} x {INT8_PROMPT} tokens and "
        f"quantisation {time.perf_counter() - t0:.1f} s; weights "
        f"{nbytes(_leaves(params)) / 1e9:.2f} GB, bf16 cache "
        f"{nbytes(cache['kv']) / 1e9:.2f} GB, int8 cache "
        f"{nbytes(cache8['kv']) / 1e9:.2f} GB")

    def window(c, kv_cache):
        first, kv_cache, pos, t1 = M.decode_multi(
            params, c, kv_cache, {"logits": logits, "positions": lengths},
            num_steps=1, act_dtype=torch.bfloat16)
        last, kv_cache, pos, t2 = M.decode_multi(
            params, c, kv_cache, {"logits": first, "positions": pos},
            num_steps=INT8_STEPS - 1, act_dtype=torch.bfloat16)
        return first.float(), last, torch.cat([t1, t2], dim=1)

    def first_step(c, kv_cache, name, attention):
        """The first step's logits on a copy of ``kv_cache``, with the
        model's attention entry point ``name`` replaced by ``attention``
        (plain torch, counted nowhere)."""
        kv = {"kv": tuple(x.clone() for x in kv_cache["kv"])}
        orig = getattr(transformer, name)
        setattr(transformer, name, attention)
        try:
            out = M.decode_multi(params, c, kv, {
                "logits": logits, "positions": lengths}, num_steps=1,
                act_dtype=torch.bfloat16)[0]
        finally:
            setattr(transformer, name, orig)
        return out.float()

    def reference_attention(q, kc, vc, ks, vs, lengths):
        kd, vd = (x.to(torch.bfloat16) * sc[..., None]
                  for x, sc in ((kc, ks), (vc, vs)))
        return dref.decode_attention_ref(q, kd, vd, lengths)

    plain_first = first_step(cfg8, cache8, "decode_attention_int8",
                             dref.decode_attention_int8_ref)
    ref_first = first_step(cfg8, cache8, "decode_attention_int8",
                           reference_attention)
    bf16_plain_first = first_step(
        cfg, cache, "gqa_decode_attention",
        lambda q, kc, vc, n: dref.decode_attention_ref(q[:, 0], kc, vc,
                                                       n)[:, None])

    reset_counts()
    t0 = time.perf_counter()
    first, last, toks = window(cfg, cache)
    torch.cuda.synchronize()
    t_bf16 = time.perf_counter() - t0
    bf16_launches = counts("launches")
    del cache
    with Recorder(transformer, "decode_attention_int8", cfg.num_layers,
                  lambda *a: tuple(x.clone() for x in a),
                  every=DECODE_SAMPLE) as kept:
        reset_counts()
        t0 = time.perf_counter()
        first8, last8, toks8 = window(cfg8, cache8)
        torch.cuda.synchronize()
        launches = counts("launches")
    t_int8 = time.perf_counter() - t0
    plain = counts("plain_calls")
    agree = (toks8 == toks).float().mean().item()
    log(f"int8 window chatglm-6b full width bf16, {rows} rows, "
        f"{INT8_STEPS} steps: {t_bf16:.1f} s (bf16 cache), {t_int8:.1f} s "
        f"(int8 cache) on the host clock; greedy tokens agree at "
        f"{agree:.4f} of {toks.numel()}; launches bf16 window "
        f"{bf16_launches}, int8 window {launches}, plain calls {plain}")

    def dist(x, y):
        """(max over all logits, median over rows of each row's max) over
        y's scale, and the share of rows whose top logit agrees"""
        d = (x - y).abs().amax(dim=-1) / y.abs().max()
        same = (x.argmax(-1) == y.argmax(-1)).float().mean().item()
        text = (f"{d.max().item():.3e} (row median "
                f"{d.median().item():.3e}, top logit agrees in {same:.3f} "
                f"of rows)")
        return d.max().item(), text

    (i8_plain, t1), (control, t2), (i8_bf16, t3), (ref_bf16, t4), \
        (i8_ref, t5) = (dist(first8, plain_first),
                        dist(first, bf16_plain_first), dist(first8, first),
                        dist(ref_first, first), dist(first8, ref_first))
    log(f"int8 window first step's logits, distance over their scale "
        f"{first.abs().max().item():.2f}: int8 window from its formulation "
        f"in plain torch {t1}; control, the bf16 window from its own {t2}; "
        f"int8 window from the bf16 window {t3}; the reference's "
        f"formulation (bf16 dequantisation) from the bf16 window {t4}; int8 "
        f"window from the reference's formulation {t5}")
    n = cfg.num_layers * INT8_STEPS
    check(bf16_launches["decode_attention"] == n,
          f"bf16 window: {bf16_launches['decode_attention']} dense decode "
          f"launches, not {n}")
    check(launches["decode_attention_int8"] == n,
          f"int8 window: {launches['decode_attention_int8']} int8 "
          f"launches, not 28 x {INT8_STEPS}")
    check(launches["decode_attention"] == 0,
          "the int8 window launched the float decode kernel")
    check(not any(plain.values()), f"plain versions ran: {plain}")
    check(kept.steps == INT8_STEPS, f"recorded {kept.steps} int8 steps")
    check(i8_plain <= 2 * control, f"int8 window {i8_plain} from its plain "
          f"formulation, past 2x the bf16 window's {control}")
    check(i8_bf16 <= 1.25 * ref_bf16, f"int8 window {i8_bf16} from the bf16"
          f" window, past 1.25x the reference formulation's {ref_bf16}")
    check(i8_ref <= 0.5 * i8_bf16, f"int8 window {i8_ref} from the "
          f"reference's formulation, past half its {i8_bf16} from float")
    check(all(torch.isfinite(x).all().item() for x in (first8, last8)),
          "non-finite logits on the int8 cache")
    check(toks8.min().item() >= 0 and toks8.max().item() < cfg.vocab_size,
          "int8 window: token out of range")
    return launches, kept.kept


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def time_scan(torch, sops, sref, calls, spin):
    """The scan kernel on each batch's layer-0 prefill scan of the SSM
    serve, held against the chunked plain version at 2e-4 of scale.  No
    single PyTorch call computes the scan, so there is no library time.
    The bound counts x, dt, b, c, y and the state once, and the chunked
    algorithm's operations: per row and chunk of n rows C.B^T over the
    lower triangle once (n (n + 1) N), per head the weighted sum over x
    (n (n + 1) P), the carried-state term and the state update (2 n P N
    each), at the 989 TFLOP/s of every bound here.  The log gives each
    shape's time beside its B, its time at the P slice the wrapper did not
    pick, and the mean bound at the rate where the kernel computes (3xTF32:
    three tf32 products each, 495 / 3 TFLOP/s) and at the f32 CUDA cores'
    67 TFLOP/s."""
    from repro_torch.kernels.ssd_scan import kernel as skernel
    per = {k: [] for k in ("ms", "plain_ms", "library_ms", "bound")}
    errs, tf32x3, f32 = [], [], []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for x, dt, a, b, c, chunk in calls:
        bsz, s, h, p = x.shape
        n = b.shape[-1]
        kern = lambda r: sops.ssd_scan(x, dt, a, b, c, chunk)
        plain = lambda r: sref.ssd_chunked_ref(x, dt, a, b, c, chunk)
        err, scale = scan_err(kern(0), plain(0))
        check(all(torch.isfinite(t).all().item() for t in kern(0)),
              "ssd_scan: non-finite at the serve's inputs")
        check(err <= SCAN_TOL * max(1.0, scale),
              f"ssd_scan: err {err} at scale {scale} at the serve's inputs")
        errs.append((err, scale))
        per["ms"].append(median_ms(torch, kern, PREFILL_REPS, spin))
        per["plain_ms"].append(median_ms(torch, plain, PREFILL_REPS, spin))
        pt = skernel.p_tile_for(bsz, h, p, sms)
        other = 32 if pt == 64 else 64
        other_ms = median_ms(
            torch, lambda r: skernel.ssd_scan_kernel(
                x, dt, a, b, c, chunk=chunk, p_tile=other),
            PREFILL_REPS, spin)
        lens = [min(chunk, s - c0) for c0 in range(0, s, chunk)]
        flops = bsz * sum(m * (m + 1) * n + h * (m * (m + 1) * p
                                                 + 4 * m * p * n)
                          for m in lens)
        nbytes = 4 * (2 * x.numel() + dt.numel() + a.numel() + b.numel()
                      + c.numel() + bsz * h * p * n)
        per["bound"].append(bound(nbytes, flops))
        tf32x3.append(max(nbytes / HBM_BYTES_PER_S,
                          3 * flops / TF32_FLOPS) * 1e3)
        f32.append(max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3)
        log(f"time ssd_scan B={bsz} S={s}: kernel {per['ms'][-1]:.4f} ms "
            f"(P slice {pt}; slice {other}: {other_ms:.4f}), plain "
            f"{per['plain_ms'][-1]:.4f}, bound {per['bound'][-1][0]:.4f} "
            f"({per['bound'][-1][1]}), 3xTF32 bound {tf32x3[-1]:.4f}")
    mean = lambda xs: sum(xs) / len(xs)
    log(f"ssd_scan mean bound at the 3xTF32 rate (495 / 3 TFLOP/s) "
        f"{mean(tf32x3):.4f} ms, at the f32 rate of the CUDA cores (67 "
        f"TFLOP/s) {mean(f32):.4f} ms, instead of 989 TFLOP/s")
    return per, errs


def time_int8(torch, dops, dref, calls, spin):
    """The int8 kernel on each kept decode step of the int8 window (its
    layer-0 query, the int8 cache and scales as the step met them, the
    lengths).  Yardsticks on the cache dequantised to bf16: SDPA with a
    length mask on the cache cut to its longest row (``library_ms``), the
    dequantisation pass that SDPA's input needs (the int8 cache cut to the
    longest row, times its scales, to bf16 in SDPA's layout), timed apart
    so that the log gives "SDPA + dequantisation", the PyTorch route's
    whole cost; and the bf16 dense decode kernel, which reads twice the
    bytes.  The bound counts q and out, int8 K/V and their bf16 scales up
    to each row's length."""
    import torch.nn.functional as F
    per = {k: [] for k in ("ms", "plain_ms", "library_ms", "bound")}
    bf16_ms, deq_ms, errs = [], [], []
    for q, kc, vc, ks, vs, lens in calls:
        b, hq, d = q.shape
        _, s, hkv, _ = kc.shape
        check(hq == hkv, "the yardstick assumes the served model's MHA")
        kern = lambda r: dops.decode_attention_int8(q, kc, vc, ks, vs, lens)
        plain = lambda r: dref.decode_attention_int8_ref(q, kc, vc, ks, vs,
                                                         lens)
        errs.append(hold(torch, "decode_attention_int8", kern(0), plain(0)))
        per["ms"].append(median_ms(torch, kern, DECODE_REPS, spin))
        per["plain_ms"].append(median_ms(torch, plain, DECODE_REPS, spin))
        kd, vd = ((x.float() * sc.float()[..., None]).to(q.dtype)
                  for x, sc in ((kc, ks), (vc, vs)))
        w = int(lens.max())
        kt, vt = (x[:, :w].transpose(1, 2).contiguous() for x in (kd, vd))
        deq = lambda r: [(x[:, :w].float() * sc[:, :w].float()[..., None])
                         .to(q.dtype).transpose(1, 2).contiguous()
                         for x, sc in ((kc, ks), (vc, vs))]
        deq(0)
        deq_ms.append(median_ms(torch, deq, DECODE_REPS, spin))
        mask = (torch.arange(w, device="cuda")[None, :]
                < lens[:, None])[:, None, None, :]
        q4 = q[:, :, None, :]
        lib = lambda r: F.scaled_dot_product_attention(q4, kt, vt,
                                                       attn_mask=mask)
        lib(0)
        per["library_ms"].append(median_ms(torch, lib, DECODE_REPS, spin))
        dense = lambda r: dops.decode_attention(q, kd, vd, lens)
        dense(0)
        bf16_ms.append(median_ms(torch, dense, DECODE_REPS, spin))
        del kd, vd, kt, vt
        n_keys = int(lens.clamp(max=s).sum())
        nbytes = (2 * q.numel() * q.element_size() + 2 * n_keys * hkv * d
                  + 2 * n_keys * hkv * ks.element_size() + b * 4)
        per["bound"].append(bound(nbytes, 4 * d * hq * n_keys))
    mean = lambda xs: sum(xs) / len(xs)
    log(f"decode_attention (bf16 kernel) on the same rows dequantised to "
        f"bf16: {mean(bf16_ms):.4f} ms (mean of per-shape medians over "
        f"{len(bf16_ms)} shapes); the dequantisation pass SDPA's input "
        f"needs {mean(deq_ms):.4f} ms, so SDPA + dequantisation "
        f"{mean(per['library_ms']) + mean(deq_ms):.4f} ms")
    return per, errs


# ---------------------------------------------------------------------------
# phase 25: sanitized serves under PyTorch's sync detector (§13)
# ---------------------------------------------------------------------------

SYNC_CUT = 2                   # chatglm-6b's layers in (b)-(e)
SYNC_SERVE = 16                # phase 5's first requests in (b)-(e)
SYNC_STEPS = 4                 # ContinuousEngine steps under the detector
SYNC_WARNING = "called a synchronizing CUDA operation"


class sync_detector:
    """Inside the block, ``torch.cuda.set_sync_debug_mode("warn")``
    reports every synchronising CUDA call the process makes as a
    warning, under ``warnings.catch_warnings(record=True)`` with
    ``simplefilter("always")``.  The warning carries no frame, so a
    ``warnings.showwarning`` hook takes ``traceback.extract_stack()`` and
    records the innermost ``repro_torch`` frame of the call (file
    basename, function, line; None when none is on the stack) in
    :attr:`records`.  Only the detector's own warning is recorded (not
    its "prototype feature" notice)."""

    def __init__(self, torch):
        self.torch = torch
        self.records = []

    def __enter__(self):
        import traceback
        import warnings

        def hook(message, category, filename, lineno, file=None, line=None):
            if SYNC_WARNING not in str(message):
                return
            frames = [f for f in traceback.extract_stack()[:-1]
                      if "/repro_torch/" in f.filename.replace(os.sep, "/")]
            self.records.append(
                (os.path.basename(frames[-1].filename), frames[-1].name,
                 frames[-1].lineno) if frames else None)

        self.torch.cuda.synchronize()
        self._cw = warnings.catch_warnings(record=True)
        self._cw.__enter__()
        warnings.simplefilter("always")
        warnings.showwarning = hook
        self.torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        self.torch.cuda.set_sync_debug_mode(0)
        self._cw.__exit__(*exc)

    def by_site(self, records=None):
        out = {}
        for r in self.records if records is None else records:
            site = r[:2] if r is not None else None
            out[site] = out.get(site, 0) + 1
        return out


def detector_calibration(torch):
    """What the sync detector reports on this card's PyTorch, one call
    at a time: name -> number of synchronising calls reported.  Fails
    unless the calls that wait for the device (a readback, a blocking
    copy either way, an index write of a Python value, a stream's
    synchronize, a data-dependent shape) are reported and their
    asynchronous forms (``fill_``, ``non_blocking`` copies) are not, so
    that a silent detector cannot pass the phase."""
    dev = torch.device("cuda")
    x = torch.arange(16, device=dev, dtype=torch.float32)
    pinned = torch.empty(16, pin_memory=True)
    host = torch.ones(16)
    event = torch.cuda.Event()
    event.record()

    def capture():
        graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
        y = torch.zeros(16, device=dev)
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            y.add_(1)
            graph.capture_begin()
            y.add_(1)
            graph.capture_end()
        torch.cuda.current_stream().wait_stream(stream)
        graph.replay()

    calls = {
        "item": lambda: x[0].item(),
        "cpu": lambda: x.cpu(),
        "stream_synchronize":
            lambda: torch.cuda.current_stream().synchronize(),
        "index_write_scalar": lambda: x.__setitem__(0, 1.0),
        "copy_to_pinned": lambda: pinned.copy_(x),
        "to_device": lambda: host.to(dev),
        "nonzero": lambda: x.nonzero(),
        "fill_": lambda: x[0].fill_(1.0),
        "copy_to_pinned_non_blocking":
            lambda: pinned.copy_(x, non_blocking=True),
        "to_device_non_blocking": lambda: host.to(dev, non_blocking=True),
        "device_synchronize": lambda: torch.cuda.synchronize(),
        "event_synchronize": lambda: event.synchronize(),
        "graph_capture_and_replay": capture,
    }
    out = {}
    for name, fn in calls.items():
        with sync_detector(torch) as det:
            fn()
        out[name] = len(det.records)
    waits = ("item", "cpu", "stream_synchronize", "index_write_scalar",
             "copy_to_pinned", "to_device", "nonzero")
    asynchronous = ("fill_", "copy_to_pinned_non_blocking",
                    "to_device_non_blocking")
    check(all(out[n] >= 1 for n in waits)
          and not any(out[n] for n in asynchronous),
          f"phase 25: the sync detector's reports {out}")
    return out


def _ledger_delta(before, after):
    return {k: after.get(k, 0) - before.get(k, 0) for k in after
            if after.get(k, 0) != before.get(k, 0)}


def sync_phase(torch, src):
    """Phase 25: the lint's sweep of the tree, then one path to each of
    the six counted sync sites under ``REPRO_SANITIZE=1`` and PyTorch's
    sync detector, every engine warmed (its graph captured) first:
    (a) phase 15's chaos plan on chatglm-6b uncut in bf16 (``step_window``
    and its NaN guard, ``_swap_out``), each window's detector syncs held
    against the ledger's counts in it; (b) a speculative serve
    (``_spec_window``); (c) one snapshot (``snapshot``); (d) one padded
    ``BatchEngine`` batch (``serve_batch``), after a first batch that
    warms its path; (e) ``ContinuousEngine.step``s.  (b)-(e) run at
    chatglm-6b's widths cut to ``SYNC_CUT`` layers.  Returns what the
    log and PERF.md need."""
    import dataclasses
    import tempfile
    from repro_torch.analysis import hotlint
    from repro_torch.analysis import sanitizer as san
    from repro_torch.configs import get_config
    from repro_torch.core.types import Batch
    from repro_torch.models import model as M
    from repro_torch.serving.engine import (BatchEngine, ContinuousEngine,
                                            PagedContinuousEngine,
                                            drive_paged)
    from repro_torch.serving.faults import FaultEvent, FaultInjector
    from repro_torch.workload.apps import make_shared_head_dataset

    t_phase = time.perf_counter()
    tree = os.path.join(src, "repro_torch")
    findings = hotlint.lint([tree])
    check(not findings, "the lint's sweep of src/repro_torch: "
          + "; ".join(f.render() for f in findings))
    static = hotlint.collect_sync_sites([tree])
    suppressed = hotlint.suppressed_sync_sites([tree])
    log(f"phase 25: lint sweep clean; counted sites {sorted(static)}; "
        f"suppressed sites {sorted(suppressed.items())}")
    calibration = detector_calibration(torch)
    log(f"phase 25: synchronising calls the detector reports, one call "
        f"each: {json.dumps(calibration)}")

    saved = os.environ.get("REPRO_SANITIZE")
    os.environ["REPRO_SANITIZE"] = "1"
    san.reset_sync_ledger()
    paths = {}
    engine_syncs = 0           # every engine's host_syncs, warm-ups too
    try:
        cfg = get_config("chatglm-6b")
        reqs = make_shared_head_dataset(N_REQUESTS, n_apps=3,
                                        gen_length=GEN_LENGTH, seed=0)

        def run(label, engine, fn):
            """``fn()`` under the detector; the ledger's and the engine's
            counts of it."""
            led0, syncs0 = san.sync_ledger(), engine.host_syncs
            with sync_detector(torch) as det:
                fn()
                torch.cuda.current_stream().query()
            paths[label] = {"ledger": _ledger_delta(led0, san.sync_ledger()),
                            "host_syncs": engine.host_syncs - syncs0,
                            "detector": det.by_site(),
                            "records": list(det.records)}
            return det

        # (a) the chaos plan on chatglm-6b uncut, warmed first
        params = M.init_params(cfg, seed=0, device="cuda",
                               dtype=torch.bfloat16)
        inj = FaultInjector(chaos_plan(FaultEvent))
        eng = PagedContinuousEngine(
            cfg, params, device="cuda", dtype=torch.bfloat16, faults=inj,
            default_ttl=CHAOS_TTL, swap_blocks=CHAOS_SWAP_BLOCKS,
            prefix_cache=True, warmup=True, **CHAOS)
        windows = []
        step_window = eng.step_window

        def counted_window(*a, **kw):
            led0, n0 = san.sync_ledger(), len(det_a.records)
            try:
                return step_window(*a, **kw)
            finally:
                windows.append((sum(_ledger_delta(
                    led0, san.sync_ledger()).values()),
                    len(det_a.records) - n0))

        eng.step_window = counted_window
        det_a = sync_detector(torch)
        led0, syncs0 = san.sync_ledger(), eng.host_syncs
        with det_a:
            st = drive_paged(eng, list(reqs), max_steps=100_000)
            torch.cuda.current_stream().query()
        del eng.step_window
        paths["chaos"] = {"ledger": _ledger_delta(led0, san.sync_ledger()),
                          "host_syncs": eng.host_syncs - syncs0,
                          "detector": det_a.by_site(),
                          "records": list(det_a.records),
                          "served": st["served"], "windows": len(windows),
                          "swap_outs": eng.swap_outs,
                          "quarantined": eng.quarantined}
        inj.release(eng.allocator)
        check(eng.graph_captures == 1 and eng.swap_outs > 0
              and eng.quarantined > 0,
              f"phase 25 (a): captures {eng.graph_captures}, swap-outs "
              f"{eng.swap_outs}, quarantined {eng.quarantined}")
        over = [(i, w) for i, w in enumerate(windows) if w[1] > w[0]]
        check(not over, f"phase 25 (a): windows whose detector syncs "
              f"exceed the ledger's counts (window, (ledger, detector)): "
              f"{over}")
        engine_syncs += eng.host_syncs
        del eng, params, inj
        torch.cuda.empty_cache()

        # (b)-(e) at chatglm-6b's widths cut to SYNC_CUT layers
        cut = dataclasses.replace(cfg, num_layers=SYNC_CUT)
        params = M.init_params(cut, seed=0, device="cuda",
                               dtype=torch.bfloat16)
        some = list(reqs[:SYNC_SERVE])
        eng = PagedContinuousEngine(
            cut, params, device="cuda", dtype=torch.bfloat16,
            prefix_cache=True, spec_decode=True, draft_k=DRAFT_K,
            warmup=True, **SERVE)
        run("spec", eng, lambda: drive_paged(eng, list(some),
                                             max_steps=100_000))
        check(eng.graph_captures == 1 and eng.spec_windows > 0,
              f"phase 25 (b): captures {eng.graph_captures}, spec windows "
              f"{eng.spec_windows}")
        engine_syncs += eng.host_syncs
        del eng

        eng = PagedContinuousEngine(cut, params, device="cuda",
                                    dtype=torch.bfloat16, prefix_cache=True,
                                    warmup=True, **SERVE)
        eng.join_many(list(some))
        eng.step_window()
        eng.join_many([])          # a window boundary: no wave pending
        with tempfile.TemporaryDirectory() as tmp:
            run("snapshot", eng,
                lambda: eng.snapshot(os.path.join(tmp, "snap.npz")))
        engine_syncs += eng.host_syncs
        del eng

        be = BatchEngine(cut, params, device="cuda", dtype=torch.bfloat16,
                         max_gen=GEN_LENGTH)
        be.serve_batch(Batch(list(some[:8])))        # warms the path
        run("padded", be, lambda: be.serve_batch(Batch(list(some[8:]))))
        check(be.graph_captures == 2, f"phase 25 (d): {be.graph_captures} "
              f"captures in two batches")

        ce = ContinuousEngine(cut, params, device="cuda",
                              dtype=torch.bfloat16, slots=4, max_len=256,
                              max_gen=GEN_LENGTH)
        for r in some[:4]:
            ce.join(r)
        ce.step()                                     # warms the step

        def steps():
            for _ in range(SYNC_STEPS):
                ce.step()

        run("continuous", ce, steps)
        ledger = san.sync_ledger()
        engine_syncs += be.host_syncs + ce.host_syncs
        del ce, be, params
        torch.cuda.empty_cache()
    finally:
        if saved is None:
            os.environ.pop("REPRO_SANITIZE", None)
        else:
            os.environ["REPRO_SANITIZE"] = saved

    # the holds
    check(set(ledger) == static,
          f"phase 25: the ledger's sites {sorted(ledger)} are not the "
          f"lint's {sorted(static)}")
    san.check_sync_ledger(static)
    check(sum(ledger.values()) == engine_syncs,
          f"phase 25: the ledger sums to {sum(ledger.values())}, the "
          f"engines' host_syncs to {engine_syncs}")
    for label, p in paths.items():
        check(sum(p["ledger"].values()) == p["host_syncs"],
              f"phase 25 {label}: ledger {p['ledger']} against host_syncs "
              f"{p['host_syncs']}")
        stray = sorted({r for r in p["records"]
                        if r is None or r[:2] not in suppressed},
                       key=str)
        check(not stray, f"phase 25 {label}: synchronising calls at "
              f"frames the lint does not suppress: {stray}")
    seconds = time.perf_counter() - t_phase
    def sites(counts):
        return json.dumps({"/".join(k) if k else "none": v
                           for k, v in sorted(counts.items(), key=str)})

    for label, p in paths.items():
        lines = {str(r): p["records"].count(r) for r in set(p["records"])}
        log(f"phase 25 {label}: ledger {sites(p['ledger'])}; host_syncs "
            f"{p['host_syncs']}; detector by site {sites(p['detector'])}; "
            f"by line {json.dumps(sorted(lines.items()))}")
    log(f"phase 25 (a): {paths['chaos']['windows']} windows, "
        f"(ledger, detector) syncs each: {windows}; served "
        f"{paths['chaos']['served']}, swap-outs "
        f"{paths['chaos']['swap_outs']}, quarantined "
        f"{paths['chaos']['quarantined']}")
    log(f"phase 25: six sites reached, the ledger equal to the lint's "
        f"sites and to host_syncs ({engine_syncs}), every detector sync "
        f"at a suppressed site; {seconds:.1f} s")
    return {"paths": paths, "windows": windows, "seconds": seconds,
            "calibration": calibration}


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 26: context-parallel decode (qwen2.5-14b at decode_32k)
# ---------------------------------------------------------------------------

# The reference's only decode_cp config, hillclimb's cp_flash_decode
# (src/repro/launch/hillclimb.py:92-97: qwen2.5-14b, its 40 query heads
# padded to 48), at decode_32k's cache length.  Two ranks share the one
# H100 as processes over a gloo group (NCCL refuses two ranks on one
# card), on a (data 1, model 2) mesh.
CP_ARCH = "qwen2.5-14b"
CP_SEQ = 32768                 # decode_32k's seq_len
CP_RANKS = 2
CP_ROWS = 4                    # (a), bf16: 25.8 GB of cache, 29.6 of weights
CP_F32_ROWS = 1                # (c), f32: 12.9 GB of cache beside 61.1 GB
#                                of f32 weights, shared by both ranks
CP_STEPS = 3
CP_POSITIONS = (32767, 20000, 16383, 0)   # (a): the ring's last slot (its
#                                           second step wraps to slot 0),
#                                           rank 1's half, the halves' edge
CP_F32_POSITIONS = (16383,)    # (c): rank 1's half empty at the first
#                                step, its first slot written at the second
CP_LENGTHS = (32768, 20000, 16384, 1)     # (b): a row whose second half
#                                           is empty, one all in rank 0's
CP_ATTN_TOL = 1e-5             # f32, absolute (tests/test_partitioning.py)
CP_BF16_TOL = 2 ** -7          # bf16 and int8 (bf16 out), of each row's
#                                own scale: both paths merge f32 partials,
#                                in other orders, then round to bf16, one
#                                step at most (2^-7 of the row's largest)
CP_PARTIAL_TOL = 2e-5          # partial kernel vs plain, of each output's
#                                scale: f32 sums of up to 16,384 terms
CP_TOL = 2e-4                  # (c)'s f32 logits, of scale
CP_INT8_TOL = 1e-2             # (c)'s logits on the int8 cache, of scale:
#                                a new K/V value that f32 rounding moves
#                                across an int8 rounding boundary moves by
#                                one step, 1/127 of its row's largest, and
#                                the steps compound it (0, 3.6e-4, 2.0e-3
#                                of scale at steps 1-3 on an H100); the
#                                written values are held apart
CP_JOIN_S = 600                # a rank's whole task, joined and killed
CP_MERGE_REPS = 51


def cp_config(decode_cp=True, cache_int8=False):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(CP_ARCH), pad_heads_to=48,
                               decode_cp=decode_cp, cache_int8=cache_int8)


def cp_cache(torch, cfg, rows, dtype, rules=None):
    """The seeded decode cache {"kv": (k, v)}, each [L, rows, CP_SEQ,
    Hkv, D] in ``dtype`` (with ``cfg.cache_int8``, the same draw in f32
    quantised: int8 values and bf16 scales), and the rules to decode it
    with.  With ``rules`` (a mesh's), each whole layer leaf is drawn on
    every rank from the same seed and placed by ``model.shard_cache``,
    which keeps this rank's block, so the blocks tile the one-device
    cache exactly; the rules are those ``shard_cache`` returns."""
    from repro_torch.models import model as M
    from repro_torch.models.transformer import _quant_i8
    kv, out_rules = None, rules
    for layer in range(cfg.num_layers):
        full = []
        for i in range(2):
            gen = torch.Generator(device="cuda").manual_seed(
                26_000 + 2 * layer + i)
            x = torch.randn((1, rows, CP_SEQ, cfg.num_kv_heads,
                             cfg.head_dim), generator=gen, device="cuda")
            full.append(x if cfg.cache_int8 else x.to(dtype))
        if cfg.cache_int8:
            (k8, ks), (v8, vs) = (_quant_i8(x) for x in full)
            full = [k8, v8, ks, vs]
        layer_cache = {"kv": tuple(full)}
        if rules is not None:
            layer_cache, out_rules = M.shard_cache(cfg, layer_cache, rules)
        if kv is None:
            kv = tuple(torch.empty((cfg.num_layers,) + x.shape[1:],
                                   dtype=x.dtype, device="cuda")
                       for x in layer_cache["kv"])
        for leaf, x in zip(kv, layer_cache["kv"]):
            leaf[layer] = x[0]
        del full, layer_cache
    return {"kv": kv}, out_rules


def cp_tokens(vocab, rows):
    import random
    rng = random.Random(26)
    return [[rng.randrange(3, vocab) for _ in range(rows)]
            for _ in range(CP_STEPS)]


def cp_steps(torch, M, params, cfg, cache, positions, tokens, dtype,
             rules=None):
    """CP_STEPS decode steps: (the f32 logits of each, on the card, and
    each step's host ms to a synchronised card)."""
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    logits, ms = [], []
    for step in range(CP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = M.decode_step(
            params, cfg, cache,
            {"tokens": torch.tensor(tokens[step], dtype=torch.int32,
                                    device="cuda"),
             "positions": pos + step}, rules=rules, act_dtype=dtype)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        logits.append(lg.float())
    return logits, ms


CP_ATTN_TAGS = ("f32", "bf16", "int8")


def _cp_attn_task(torch, mesh, shared):
    """(b) on one rank: its blocks of the f32, bf16 and int8 caches, the
    context-parallel attention (counts zeroed just before, read just
    after), and its partial kernel against the plain version on its
    shard."""
    from repro_torch.kernels.decode_attention import ops, ref
    from repro_torch.models.attention import (batch_spec,
                                              gqa_decode_attention_cp)
    from repro_torch.partitioning import shard_local
    out = {}
    r = mesh.get_local_rank("model")
    lengths = shared["lengths"]
    spec = (batch_spec(mesh, lengths.shape[0]), "model")
    for tag in CP_ATTN_TAGS:
        q = shared[f"q_{tag}"]
        names = ("k", "v", "ks", "vs") if tag == "int8" else ("k", "v")
        blocks = [shard_local(shared[f"{n}_{tag}"], spec, mesh).contiguous()
                  for n in names]
        if tag == "int8":
            fn, plain = (ops.decode_attention_int8_partial,
                         ref.decode_attention_int8_partial_ref)
            scales = {"k_scale": blocks[2], "v_scale": blocks[3]}
        else:
            fn, plain = (ops.decode_attention_partial,
                         ref.decode_attention_partial_ref)
            scales = {}
        ops.reset_counts()
        o = gqa_decode_attention_cp(q[:, None], blocks[0], blocks[1],
                                    lengths, mesh=mesh, **scales)
        torch.cuda.synchronize()
        launches = {f.__name__: f.launches for f in ops.KERNELS}
        local = torch.clamp(lengths - r * blocks[0].shape[1], 0,
                            blocks[0].shape[1])
        got = fn(q, *blocks, local)
        want = plain(q, *blocks, local)
        errs = []
        for name, x, y in zip(("o", "m", "l"), got, want):
            live = torch.isfinite(y)
            check(torch.equal(torch.isfinite(x), live),
                  f"phase 26 (b) {tag} rank {r}: {name}'s -inf differ")
            if not live.any():
                continue
            err = (x[live] - y[live]).abs().max().item()
            scale = max(1.0, y[live].abs().max().item())
            check(err <= CP_PARTIAL_TOL * scale,
                  f"phase 26 (b) {tag} rank {r}: partial {name} err {err} "
                  f"at scale {scale}")
            errs.append(err)
        out[tag] = {"out": o[:, 0].float().cpu().numpy(),
                    "launches": launches, "partial_errs": errs}
        del blocks
    return out


def _cp_steps_task(torch, mesh, shared):
    """(c) on one rank: its block of the seeded f32 cache (placed by
    ``model.shard_cache``), CP_STEPS whole decode steps under the rules
    it returns (counts zeroed just before, read just after; the
    sanitizer's ledger on); the same on the int8 cache (counts zeroed
    again); then the merge's three all-reduces timed at a layer's
    shapes."""
    import torch.distributed as dist
    from repro_torch.analysis import sanitizer as san
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.models import model as M
    from repro_torch.partitioning import sharding_rules, with_mesh_rules
    cfg = cp_config()
    mrules = with_mesh_rules(sharding_rules("decode"), mesh)
    cache, rules = cp_cache(torch, cfg, CP_F32_ROWS, torch.float32, mrules)
    check(rules.get("_kv_len") == CP_SEQ
          and cache["kv"][0].shape[2] == CP_SEQ // CP_RANKS,
          f"phase 26 (c): shard_cache kept {tuple(cache['kv'][0].shape)}")
    os.environ["REPRO_SANITIZE"] = "1"
    san.reset_sync_ledger()
    ops.reset_counts()
    logits, ms = cp_steps(torch, M, shared["params"], cfg, cache,
                          CP_F32_POSITIONS, shared["tokens"], torch.float32,
                          rules=rules)
    launches = {fn.__name__: fn.launches for fn in ops.KERNELS}
    ledger = san.sync_ledger()
    os.environ["REPRO_SANITIZE"] = "0"
    del cache
    cfg8 = cp_config(cache_int8=True)
    cache, rules8 = cp_cache(torch, cfg8, CP_F32_ROWS, torch.float32,
                             mrules)
    ops.reset_counts()
    logits8, ms8 = cp_steps(torch, M, shared["params"], cfg8, cache,
                            CP_F32_POSITIONS, shared["tokens"],
                            torch.float32, rules=rules8)
    launches8 = {fn.__name__: fn.launches for fn in ops.KERNELS}
    written8 = cp_written(cache, mesh.get_local_rank("model"),
                          cache["kv"][0].shape[2])
    del cache
    hq = max(cfg.num_heads, cfg.pad_heads_to)
    group = mesh.get_group("model")
    m = torch.randn(CP_F32_ROWS, hq, device="cuda")
    l = torch.rand(CP_F32_ROWS, hq, device="cuda")
    o = torch.randn(CP_F32_ROWS, hq, cfg.head_dim, device="cuda")
    merge = []
    for _ in range(CP_MERGE_REPS):
        dist.barrier(group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mm = m.clone()
        dist.all_reduce(mm, op=dist.ReduceOp.MAX, group=group)
        corr = torch.exp(m - mm)
        ll = l * corr
        dist.all_reduce(ll, group=group)
        oo = o * corr[..., None]
        dist.all_reduce(oo, group=group)
        torch.cuda.synchronize()
        merge.append((time.perf_counter() - t0) * 1e3)
    return {"logits": [x.cpu().numpy() for x in logits], "step_ms": ms,
            "launches": launches,
            "logits8": [x.cpu().numpy() for x in logits8], "step_ms8": ms8,
            "launches8": launches8, "written8": written8,
            "ledger": {"/".join(k): v
                                             for k, v in ledger.items()},
            "merge_ms": statistics.median(merge)}


CP_TASKS = {"attn": _cp_attn_task, "steps": _cp_steps_task}


def cp_written(cache, r=0, block=CP_SEQ):
    """{global slot: [each leaf's slot, every layer and row, as numpy
    f32]} for the slots (c)'s steps write that lie in block ``r`` of
    ``block`` slots of ``cache``."""
    out = {}
    for pos in CP_F32_POSITIONS:
        for step in range(CP_STEPS):
            x = (pos + step) % CP_SEQ
            if r * block <= x < (r + 1) * block:
                out[x] = [leaf[:, :, x - r * block].float().cpu().numpy()
                          for leaf in cache["kv"]]
    return out


def cp_rank(rank, world, port, task, shared, results):
    """One rank of phase 26, a process of its own on the card: joins a
    gloo group of ``world`` ranks, builds the (1, world) mesh, runs
    ``CP_TASKS[task]`` and puts (rank, "ok" or "error", result) on
    ``results``.  Results hold numpy arrays, pickled by value: a tensor
    shared through the queue would need this process alive when the
    parent reads it."""
    import datetime
    import traceback
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    try:
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=300))
        from repro_torch.launch.mesh import make_test_mesh
        mesh = make_test_mesh((1, world), ("data", "model"),
                              device_type="cuda")
        out = CP_TASKS[task](torch, mesh, shared)
        dist.barrier()
        results.put((rank, "ok", out))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def cp_spawn(task, shared):
    """Run ``task`` on CP_RANKS processes (CUDA tensors in ``shared``
    pass by CUDA IPC, no copy); the ranks are joined within CP_JOIN_S
    seconds and killed on any failure.  Returns their results by rank."""
    import queue
    import socket
    import torch
    import torch.multiprocessing as tmp
    ctx = tmp.get_context("spawn")
    results = ctx.Queue()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [ctx.Process(target=cp_rank,
                         args=(r, CP_RANKS, port, task, shared, results))
             for r in range(CP_RANKS)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.monotonic() + CP_JOIN_S
    try:
        while len(got) < CP_RANKS:
            try:
                rank, status, out = results.get(
                    timeout=max(1.0, deadline - time.monotonic()))
            except queue.Empty:
                raise SmokeFailure(f"phase 26 {task}: ranks {sorted(got)} "
                                   f"of {CP_RANKS} answered in "
                                   f"{CP_JOIN_S} s") from None
            check(status == "ok", f"phase 26 {task} rank {rank}:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        check(all(p.exitcode == 0 for p in procs),
              f"phase 26 {task}: exit codes {[p.exitcode for p in procs]}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        torch.cuda.ipc_collect()   # free what the ranks held of ``shared``
    return [got[r] for r in range(CP_RANKS)]


def cp_attention_check(torch, ops):
    """(b): one layer's context-parallel attention at decode_32k's
    shapes (B 4, S 32,768 split 2 x 16,384, 48 query heads over 8 KV
    heads of 128) against the one-device decode kernel on the whole
    cache: f32 within CP_ATTN_TOL; bf16, and the int8 cache (the f32
    draw quantised, bf16 queries) against the one-device int8 kernel,
    each row within CP_BF16_TOL of its own scale; each rank's partial
    kernel (float, int8) launched once and held against its plain
    version."""
    from repro_torch.models.transformer import _quant_i8
    cfg = cp_config()
    hq, hkv, d = max(cfg.num_heads, cfg.pad_heads_to), cfg.num_kv_heads, \
        cfg.head_dim
    gen = torch.Generator(device="cuda").manual_seed(261)
    shared = {"lengths": torch.tensor(CP_LENGTHS, dtype=torch.int32,
                                      device="cuda")}
    b = len(CP_LENGTHS)
    for tag, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        shared[f"q_{tag}"] = torch.randn(b, hq, d, generator=gen,
                                         device="cuda").to(dt)
        for n in ("k", "v"):
            shared[f"{n}_{tag}"] = torch.randn(b, CP_SEQ, hkv, d,
                                               generator=gen,
                                               device="cuda").to(dt)
    shared["q_int8"] = shared["q_bf16"]
    for n in ("k", "v"):
        shared[f"{n}_int8"], shared[f"{n}s_int8"] = _quant_i8(
            shared[f"{n}_f32"])
    want = {tag: ops.decode_attention(shared[f"q_{tag}"], shared[f"k_{tag}"],
                                      shared[f"v_{tag}"], shared["lengths"])
            for tag in ("f32", "bf16")}
    want["int8"] = ops.decode_attention_int8(
        shared["q_int8"], shared["k_int8"], shared["v_int8"],
        shared["ks_int8"], shared["vs_int8"], shared["lengths"])
    torch.cuda.synchronize()
    ranks = cp_spawn("attn", shared)
    kernel = {"f32": "decode_attention_partial",
              "bf16": "decode_attention_partial",
              "int8": "decode_attention_int8_partial"}
    rows = {}
    for tag in CP_ATTN_TAGS:
        w = want[tag].float().cpu()
        row_scale = w.flatten(1).abs().amax(1)               # [B]
        errs, ratios = [], []
        for r in ranks:
            diff = (torch.from_numpy(r[tag]["out"]) - w).flatten(1).abs()
            errs.append(diff.max().item())
            ratios.append((diff.amax(1) / row_scale).max().item())
        if tag == "f32":
            bound = CP_ATTN_TOL
            check(max(errs) <= bound, f"phase 26 (b) f32: the ranks' "
                  f"outputs lie {errs} from the one-device kernel's, bound "
                  f"{bound}")
            said = f"bound {bound:.3e} absolute"
        else:
            check(max(ratios) <= CP_BF16_TOL, f"phase 26 (b) {tag}: the "
                  f"ranks' outputs lie {ratios} of a row's own scale from "
                  f"the one-device kernel's, bound {CP_BF16_TOL}")
            said = (f"largest of a row's own scale {max(ratios):.3e}, "
                    f"bound {CP_BF16_TOL:.3e}; row scales "
                    f"{[round(x, 5) for x in row_scale.tolist()]}")
        for r in ranks:
            n = r[tag]["launches"]
            want_n = {name: 0 for name in n}
            want_n[kernel[tag]] = 1
            check(n == want_n, f"phase 26 (b) {tag}: launches {n}")
        rows[tag] = {"errs": errs, "ratios": ratios,
                     "partial_errs": [r[tag]["partial_errs"] for r in ranks]}
        log(f"phase 26 (b) {tag}: both ranks' context-parallel attention "
            f"({kernel[tag]} once a rank) within {max(errs):.3e} of the "
            f"one-device {'int8 ' if tag == 'int8' else ''}decode kernel "
            f"({said}); partial kernel against its plain version (o, m, l "
            f"max abs err) {rows[tag]['partial_errs']}")
    del shared, want
    torch.cuda.empty_cache()
    return rows


def cp_one_device(torch, M, ops, reset_counts, counts):
    """(a): qwen2.5-14b uncut in bf16 on one device, no mesh: the
    decode_cp config decodes CP_STEPS steps from the seeded cache of
    CP_ROWS rows bit-equal to the flag off (logits and the written
    slots), the dense decode kernel once a layer and step, no partial;
    then a few requests through BatchEngine, flag on against off."""
    from repro_torch.core.types import Batch
    from repro_torch.serving.engine import BatchEngine
    on, off = cp_config(), cp_config(decode_cp=False)
    t0 = time.perf_counter()
    params = M.init_params(on, seed=0, device="cuda", dtype=torch.bfloat16)
    log(f"phase 26 (a) {CP_ARCH} weights (bf16, 48 query heads): "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB allocated")
    tokens = cp_tokens(on.vocab_size, CP_ROWS)
    runs = {}
    for label, cfg in (("off", off), ("on", on)):
        cache, _ = cp_cache(torch, cfg, CP_ROWS, torch.bfloat16)
        reset_counts()
        logits, ms = cp_steps(torch, M, params, cfg, cache, CP_POSITIONS,
                              tokens, torch.bfloat16)
        launches = counts("launches")
        rows = torch.arange(CP_ROWS, device="cuda")
        slots = [(torch.tensor(CP_POSITIONS, device="cuda") + s) % CP_SEQ
                 for s in range(CP_STEPS)]
        written = torch.stack([leaf[:, rows, sl] for leaf in cache["kv"]
                               for sl in slots])
        runs[label] = (logits, written, ms, launches)
        del cache
        torch.cuda.empty_cache()
    (l_off, w_off, ms_off, n_off), (l_on, w_on, ms_on, n_on) = \
        runs["off"], runs["on"]
    layers = on.num_layers
    for label, n in (("off", n_off), ("on", n_on)):
        want = {name: 0 for name in n}
        want["decode_attention"] = layers * CP_STEPS
        check(n == want, f"phase 26 (a) flag {label}: launches {n}, not "
              f"{want}")
    check(all(torch.equal(a, b) for a, b in zip(l_on, l_off))
          and torch.equal(w_on, w_off),
          "phase 26 (a): decode_cp on one device is not bit-equal to the "
          "flag off")
    reqs, targets = phase7_requests(on.vocab_size)
    reqs = reqs[:4]
    streams = {}
    for label, cfg in (("off", off), ("on", on)):
        eng = BatchEngine(cfg, params, dtype=torch.bfloat16, device="cuda",
                          max_gen=DENSE_MAX_GEN)
        res = eng.serve_batch(Batch(requests=list(reqs)))
        streams[label] = res.generated
        del eng
    check(streams["on"] == streams["off"]
          and all(len(streams["on"][r.req_id]) == targets[r.req_id]
                  for r in reqs),
          "phase 26 (a): BatchEngine's streams differ with decode_cp on")
    log(f"phase 26 (a) {CP_ARCH} uncut bf16, {CP_ROWS} rows x {CP_SEQ} "
        f"slots, positions {CP_POSITIONS}: {CP_STEPS} steps with decode_cp "
        f"on bit-equal to off (logits and written slots), dense decode "
        f"{layers * CP_STEPS} launches each; step host ms on "
        f"{[round(x, 2) for x in ms_on]}, off "
        f"{[round(x, 2) for x in ms_off]}; BatchEngine served "
        f"{len(reqs)} requests "
        f"({sum(len(s) for s in streams['on'].values())} tokens), streams "
        f"equal on and off")
    del params
    torch.cuda.empty_cache()


def cp_partial_times(torch, ops, ref, spin, b, s, hq, hkv, d, dtype,
                     lengths, int8=False):
    """The partial kernel at a shard of [b, s] slots with ``lengths``
    valid (``int8``: the int8 kernel on the same draw quantised), beside
    its plain version, its bound and SDPA with a length mask on the same
    shard (the nearest single PyTorch call: it returns the normalised
    output, not the partial; for int8, on the shard dequantised apart,
    as ``time_int8``'s yardstick); median CUDA-event ms."""
    import torch.nn.functional as F
    from repro_torch.models.transformer import _quant_i8
    gen = torch.Generator(device="cuda").manual_seed(262)
    q = torch.randn(b, hq, d, generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn(b, s, hkv, d, generator=gen, device="cuda")
            .to(torch.float32 if int8 else dtype) for _ in range(2))
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    if int8:
        (k8, ks), (v8, vs) = _quant_i8(k), _quant_i8(v)
        fn, args = ops.decode_attention_int8_partial, (q, k8, v8, ks, vs,
                                                       lens)
        plain_fn = ref.decode_attention_int8_partial_ref
        k, v = ((x.float() * sc.float()[..., None]).to(dtype)
                for x, sc in ((k8, ks), (v8, vs)))
    else:
        fn, args = ops.decode_attention_partial, (q, k, v, lens)
        plain_fn = ref.decode_attention_partial_ref
    kern = lambda r: fn(*args)
    plain = lambda r: plain_fn(*args)
    got, want = kern(0), plain(0)
    err = max(((x - y)[torch.isfinite(y)].abs().max().item()
               if torch.isfinite(y).any() else 0.0)
              for x, y in zip(got, want))
    n0 = fn.launches
    row = {"ms": median_ms(torch, kern, 11, spin),
           "plain_ms": median_ms(torch, plain, 5, spin)}
    fn.launches = n0   # timing launches: not the main path's
    w = int(lens.max())
    kt, vt = (x[:, :w].transpose(1, 2).repeat_interleave(hq // hkv, 1)
              .contiguous() for x in (k, v))
    mask = (torch.arange(w, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    lib = lambda r: F.scaled_dot_product_attention(q[:, :, None, :], kt, vt,
                                                   attn_mask=mask)
    lib(0)
    row["library_ms"] = median_ms(torch, lib, 11, spin)
    e = q.element_size()
    n_keys = int(lens.clamp(max=s).sum())
    kv_bytes = (2 * n_keys * hkv * (d + 2) if int8   # int8 values, bf16
                else 2 * n_keys * hkv * d * e)       # scales
    nbytes = q.numel() * e + kv_bytes + b * 4 + 4 * b * hq * (d + 2)
    row["bound_ms"], row["bound_by"] = bound(nbytes, 4 * d * hq * n_keys)
    row["max_abs_err"] = err
    return row


def cp_phase(torch, ops, ref, spin, reset_counts, counts):
    """Phase 26: context-parallel decode.  (a) one device, no mesh
    (``cp_one_device``); (b) one layer's context-parallel attention on
    two ranks (``cp_attention_check``); (c) the two ranks run whole f32
    decode steps of qwen2.5-14b uncut, 1 row (CP_F32_ROWS: the f32
    weights, 61.1 GB, are shared by CUDA IPC; two f32 copies would not
    fit), each rank's cache placed by ``model.shard_cache``, held at
    CP_TOL of scale against the same steps on one device, then the same
    on the int8 cache (the int8 partial kernel; CP_INT8_TOL, and the
    written K/V against the one-device write); then the partial
    kernels, the merge and the steps timed.  Returns ({kernel: timing
    row}, {kernel: launches on rank 0}, (b)'s rows)."""
    import numpy as np
    from repro_torch.models import model as M
    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout else "?"
    attn = cp_attention_check(torch, ops)
    cp_one_device(torch, M, ops, reset_counts, counts)
    cfg, cfg8 = cp_config(), cp_config(cache_int8=True)
    layers = cfg.num_layers
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, device="cuda", dtype=torch.float32)
    log(f"phase 26 (c) f32 weights: {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
    tokens = cp_tokens(cfg.vocab_size, CP_F32_ROWS)
    one = {}
    for c, dense in ((cfg, "decode_attention"),
                     (cfg8, "decode_attention_int8")):
        cache, _ = cp_cache(torch, c, CP_F32_ROWS, torch.float32)
        reset_counts()
        lg, ms = cp_steps(torch, M, params, c, cache, CP_F32_POSITIONS,
                          tokens, torch.float32)
        n = counts("launches")
        want = {name: 0 for name in n}
        want[dense] = layers * CP_STEPS
        check(n == want, f"phase 26 (c) one-device launches {n}, not {want}")
        one[dense] = ([x.cpu() for x in lg], ms, cp_written(cache))
        del cache
        torch.cuda.empty_cache()
    ranks = cp_spawn("steps", {"params": params, "tokens": tokens})
    site = "attention.py/gqa_decode_attention_cp"
    errs, agree = {"f32": [], "int8": []}, {"f32": [], "int8": []}
    # the int8 K/V the steps wrote: each slot by one rank, its values
    # within one int8 step and its scales within one bf16 step of the
    # one-device run's
    want8 = one["decode_attention_int8"][2]
    got8 = {x: leaves for res in ranks for x, leaves in
            res["written8"].items()}
    check(sorted(got8) == sorted(want8)
          and sum(len(res["written8"]) for res in ranks) == len(want8),
          f"phase 26 (c) int8: slots written {sorted(got8)}, "
          f"not {sorted(want8)}")
    moved = 0
    for x, leaves in want8.items():
        for i, (g, w) in enumerate(zip(got8[x], leaves)):
            d = np.abs(g - w)
            bound = 1.0 if i < 2 else 2.0 ** -7 * np.abs(w)
            check(bool((d <= bound).all()), f"phase 26 (c) int8 slot {x} "
                  f"leaf {i}: {d.max()} from the one-device write")
            moved += int((d > 0).sum()) if i < 2 else 0
    tol = {"f32": CP_TOL, "int8": CP_INT8_TOL}
    for r, res in enumerate(ranks):
        for tag, key, kern, dense in (
                ("f32", "", "decode_attention_partial", "decode_attention"),
                ("int8", "8", "decode_attention_int8_partial",
                 "decode_attention_int8")):
            want = {name: 0 for name in res["launches" + key]}
            want[kern] = layers * CP_STEPS
            check(res["launches" + key] == want, f"phase 26 (c) {tag} rank "
                  f"{r} launches {res['launches' + key]}, not {want}")
            for got, w in zip(res["logits" + key], one[dense][0]):
                got = torch.from_numpy(got)
                scale = max(1.0, w.abs().max().item())
                err = (got - w).abs().max().item()
                check(err <= tol[tag] * scale, f"phase 26 (c) {tag} rank "
                      f"{r}: logits {err} from the one-device run at scale "
                      f"{scale}")
                errs[tag].append(err / scale)
                agree[tag].append(torch.equal(got.argmax(-1), w.argmax(-1)))
        check(res["ledger"] == {site: 3 * layers * CP_STEPS},
              f"phase 26 (c) rank {r} sync ledger {res['ledger']}")
    del params
    torch.cuda.empty_cache()
    hq = max(cfg.num_heads, cfg.pad_heads_to)
    half = CP_SEQ // CP_RANKS
    shard = (CP_F32_ROWS, half, hq, cfg.num_kv_heads, cfg.head_dim,
             torch.float32, [half] * CP_F32_ROWS)
    rows = {"decode_attention_partial":
            cp_partial_times(torch, ops, ref, spin, *shard),
            "decode_attention_int8_partial":
            cp_partial_times(torch, ops, ref, spin, *shard, int8=True)}
    b_lens = [min(x, half) for x in CP_LENGTHS]
    b_row = cp_partial_times(torch, ops, ref, spin, len(CP_LENGTHS), half,
                             hq, cfg.num_kv_heads, cfg.head_dim,
                             torch.bfloat16, b_lens)
    r0 = ranks[0]
    for tag in ("f32", "int8"):
        log(f"phase 26 (c) {CP_ARCH} uncut, f32 activations, "
            f"{'int8' if tag == 'int8' else 'f32'} cache, {CP_F32_ROWS} "
            f"row x {CP_SEQ} slots on 2 ranks (cut: {CP_F32_ROWS} row, the "
            f"f32 weights shared by CUDA IPC), positions "
            f"{CP_F32_POSITIONS}: logits within {max(errs[tag]):.3e} of "
            f"scale of the one-device run (each step, rank 0 then 1: "
            f"{[float(f'{e:.3e}') for e in errs[tag]]}; bound {tol[tag]}); "
            f"greedy "
            f"tokens agree {sum(agree[tag])}/{len(agree[tag])}; partial "
            f"kernel launches a rank {layers * CP_STEPS}, dense decode 0")
    log(f"phase 26 (c) int8: the {len(want8)} written slots each from one "
        f"rank, values within one int8 step and scales within one bf16 "
        f"step of the one-device write; {moved} int8 values moved a step")
    log(f"phase 26 (c) sync ledger {r0['ledger']}")
    fmt = lambda row: json.dumps({k: (round(v, 4) if isinstance(v, float)
                                      else v) for k, v in row.items()})
    log(f"phase 26 [{card}] partial kernels at (c)'s shard (f32 q, 1 x "
        f"{half} valid of {half}, 48/8 heads of 128): float "
        + fmt(rows["decode_attention_partial"]) + "; int8 "
        + fmt(rows["decode_attention_int8_partial"])
        + f"; float at (b)'s bf16 shard (4 rows, {b_lens} valid): "
        + fmt(b_row))
    log(f"phase 26 [{card}] merge (3 all-reduces on gloo, host-staged) "
        f"{r0['merge_ms']:.3f} ms a layer, rank 1 "
        f"{ranks[1]['merge_ms']:.3f}; step host ms rank 0 "
        f"{[round(x, 2) for x in r0['step_ms']]}, rank 1 "
        f"{[round(x, 2) for x in ranks[1]['step_ms']]}, one device "
        f"{[round(x, 2) for x in one['decode_attention'][1]]}; int8 cache "
        f"rank 0 {[round(x, 2) for x in r0['step_ms8']]}, one device "
        f"{[round(x, 2) for x in one['decode_attention_int8'][1]]}; "
        f"phase 26 {time.perf_counter() - t_start:.1f} s")
    launches = {"decode_attention_partial":
                r0["launches"]["decode_attention_partial"],
                "decode_attention_int8_partial":
                r0["launches8"]["decode_attention_int8_partial"]}
    return rows, launches, attn


# ---------------------------------------------------------------------------
# phase 27: the dry run and the roofline
# ---------------------------------------------------------------------------

ROOF_JOBS = 6                  # (a): the dry run's worker processes
ROOF_TIMEOUT = 300             # (a): each subprocess's limit, s
ROOF_BUSY = 0.95               # (b): busy >= this x max(t_compute, floor)
ROOF_PEAK_TOL = 0.10           # (b): predicted peak against the allocator's
RECORDED_STEP_MS = 215.83      # smollm-135m's f32 eager step as PERF.md
#                                §5 records it (the launcher's median)


def op_host_cost(torch, card):
    """Phase 2's line: the host's µs to call one decode launch through
    its registered op, through the wrapper, and through ``kernel.py``
    directly (alternated, median of each; bf16, 4 rows of 8/2 heads of
    128 against 256 slots: the card keeps up with the host)."""
    from repro_torch.kernels.decode_attention import kernel, ops
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = dict(device="cuda", dtype=torch.bfloat16)
    q = torch.randn(4, 8, 128, generator=gen, **bf)
    k = torch.randn(4, 256, 2, 128, generator=gen, **bf)
    v = torch.randn(4, 256, 2, 128, generator=gen, **bf)
    n = torch.full((4,), 256, dtype=torch.int32, device="cuda")
    calls = {"kernel.py": lambda: kernel.decode_attention_kernel(q, k, v, n),
             "registered op": lambda: ops._DECODE_OP(q, k, v, n),
             "wrapper": lambda: ops.decode_attention(q, k, v, n)}
    times = {name: [] for name in calls}
    for name in list(calls) + list(calls)[::-1] + list(calls):
        fn = calls[name]
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(1000):
            fn()
        times[name].append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    ops.reset_counts()
    log(f"phase 2 [{card}] host us a dense decode launch (median of 3 x "
        f"1,000 calls): " + json.dumps(
            {k: round(statistics.median(v), 2) for k, v in times.items()}))


def _wall(popen_args, timeout):
    """Run a command in its own session; kill the session past
    ``timeout``.  Returns (returncode, stdout, stderr, seconds)."""
    import signal
    t0 = time.perf_counter()
    p = subprocess.Popen(popen_args, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True,
                         start_new_session=True,
                         env=dict(os.environ, PYTHONPATH=os.path.join(
                             ROOT, "src")))
    try:
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out, err = p.communicate()
        raise RuntimeError(f"{popen_args[2]} passed its {timeout} s limit: "
                           f"{err[-2000:]}")
    return p.returncode, out, err, time.perf_counter() - t0


def dryrun_start(pool, tmp):
    """(a), started: ``launch.dryrun --all`` and ``launch.hillclimb`` in
    subprocesses, side by side on ``pool``'s threads, writing under
    ``tmp``.  Returns {name: future} for :func:`dryrun_check`."""
    cmds = {"dryrun": [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--all", "--jobs", str(ROOF_JOBS), "--out",
                       os.path.join(tmp, "dryrun.jsonl")],
            "hillclimb": [sys.executable, "-m",
                          "repro_torch.launch.hillclimb", "--out",
                          os.path.join(tmp, "hillclimb.jsonl")]}
    return {k: pool.submit(_wall, c, ROOF_TIMEOUT) for k, c in cmds.items()}


def dryrun_check(futs, tmp, total_gib):
    """(a), finished: every record of :func:`dryrun_start`'s runs listed
    by status with its predicted peak against the card's memory and its
    dominant term."""
    dry, hill = os.path.join(tmp, "dryrun.jsonl"), os.path.join(
        tmp, "hillclimb.jsonl")
    done = {k: f.result() for k, f in futs.items()}
    summary = {}
    for name, (rc, out, err, secs) in done.items():
        check(rc == 0, f"{name} exited {rc}: {err[-3000:]}")
        summary[name] = json.loads(out.strip().splitlines()[-1])
        recs = [json.loads(x) for x in open(dry if name == "dryrun"
                                            else hill)]
        by = {s: sum(r["status"] == s for r in recs)
              for s in ("ok", "skipped", "error")}
        over = [r for r in recs if r["status"] == "ok"
                and r["peak_mem_gib"] > total_gib]
        log(f"phase 27 (a) {name}: {len(recs)} records {by} in "
            f"{secs:.1f} s (trace s summed "
            f"{sum(r.get('trace_s') or 0 for r in recs):.1f}); "
            f"{len(over)} of {by['ok']} ok records need more than the "
            f"card's {total_gib:.1f} GiB; {json.dumps(summary[name])}")
        for r in recs:
            tag = r.get("iteration") or r["mesh"]
            if r["status"] == "ok":
                log(f"  {r['arch']} {r['shape']} {tag}: peak "
                    f"{r['peak_mem_gib']:.2f} / {total_gib:.1f} GiB, "
                    f"{r['dominant']} (t_compute {r['t_compute_s']:.4g} s, "
                    f"t_memory {r['t_memory_s']:.4g} s, floor "
                    f"{r['t_memory_lb_s']:.4g} s, collective "
                    f"{r['t_collective_s']:.4g} s)")
            else:
                log(f"  {r['arch']} {r['shape']} {tag}: {r['status']} "
                    f"{(r.get('reason') or r.get('error', ''))[-300:]}")
        check(by["error"] == 0 and summary[name]["errors"] == 0,
              f"{name}: {by['error']} error records")
        check(not summary[name]["cuda_initialized"]
              and summary[name]["memory_allocated"] == 0,
              f"{name} touched the card: {summary[name]}")
    check(len([json.loads(x) for x in open(dry)]) == 80,
          "the dry run did not write 10 archs x 4 shapes x 2 meshes")


def roofline_step(torch, label, fn, args, cfg, kind, tokens):
    """(b) one step: dry-run ``fn(*args)`` (meta stand-ins), then run it
    on the card under ``FlopCounterMode`` (equal FLOPs), profiled (busy
    >= ``ROOF_BUSY`` x max(t_compute, the memory floor)), and its peak
    (``max_memory_allocated`` over the step, less what was allocated
    beside its arguments) within ``ROOF_PEAK_TOL`` of the prediction.
    Returns the counts."""
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch import dryrun, roofline as rl
    t0 = time.perf_counter()
    c = rl.count_costs(fn, *args)
    trace = time.perf_counter() - t0
    static = dryrun.static_bytes(args)
    floor = dryrun.memory_floor_bytes(cfg, kind, static, tokens) / rl.HBM_BW
    t_compute, t_memory = c["flops"] / rl.PEAK_FLOPS, c["bytes"] / rl.HBM_BW
    out = fn(*args)                               # warm
    del out
    torch.cuda.synchronize()
    beside = torch.cuda.memory_allocated() - static
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as fc:
        out = fn(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - beside
    del out
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn(*args)
        torch.cuda.synchronize()
    del out
    busy = _device_us(prof) / 1e3
    lower = max(t_compute, floor) * 1e3
    log(f"phase 27 (b) {label}: FLOPs dry {c['flops']:.6g}, card "
        f"{fc.get_total_flops():.6g}; busy {busy:.3f} ms against "
        f"t_compute {t_compute * 1e3:.3f}, the memory floor "
        f"{floor * 1e3:.3f} (t_memory_lb_s) and t_memory "
        f"{t_memory * 1e3:.3f} ms (the upper count: busy is "
        f"{busy / (t_memory * 1e3):.3f} of it); peak predicted "
        f"{c['peak_bytes'] / 2 ** 30:.3f} GiB, max_memory_allocated "
        f"{peak / 2 ** 30:.3f} GiB ({c['peak_bytes'] / peak - 1:+.2%}); "
        f"dominant {rl.Roofline(c['flops'], c['bytes'], 0, {}, 0).dominant}"
        f"; traced in {trace:.1f} s")
    check(fc.get_total_flops() == c["flops"],
          f"{label}: the card's FLOPs {fc.get_total_flops()} are not the "
          f"dry run's {c['flops']}")
    check(busy >= ROOF_BUSY * lower,
          f"{label}: busy {busy:.3f} ms under {ROOF_BUSY} x {lower:.3f} ms")
    check(abs(c["peak_bytes"] - peak) <= ROOF_PEAK_TOL * peak,
          f"{label}: predicted peak {c['peak_bytes']} not within "
          f"{ROOF_PEAK_TOL:.0%} of {peak}")
    return {**c, "busy_ms": busy, "peak": peak}


def roofline_phase(torch, card):
    """Phase 27: the dry run and the roofline.  (b)
    :func:`roofline_step` at three steps earlier phases run at full
    width: smollm-135m's f32 training step at phase 23's B 8, S 256 (and
    its eager host ms against ``RECORDED_STEP_MS``), mamba2-780m's (phase
    24's), and chatglm-6b's bf16 padded decode step at phase 7's 20 rows
    with every row's cache at capacity (the roofline's bytes beside
    :func:`padded_step_bound`'s); (a) (:func:`dryrun_start`, CPU only)
    runs beside the two device-bound steps, after the host-bound smollm
    step is timed."""
    import concurrent.futures
    import tempfile
    import types
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as O
    from repro_torch.train import trainer as T
    t0 = time.perf_counter()
    total = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
    log(f"phase 27: {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
        f"allocated before it")
    gen = torch.Generator(device="cuda").manual_seed(0)
    tmp = tempfile.TemporaryDirectory()
    pool = concurrent.futures.ThreadPoolExecutor(2)
    futs = None
    for arch in (TRAIN_ARCH, "mamba2-780m"):
        cfg = get_config(arch)
        opt = O.AdamWConfig(total_steps=TRAIN_STEPS)
        params = M.init_params(cfg, seed=0, device="cuda")
        args = (params, O.init(opt, params), {"tokens": torch.randint(
            0, cfg.vocab_size, (8, 256), generator=gen, device="cuda",
            dtype=torch.int32)})
        step = T.make_train_step(cfg, opt, act_dtype=torch.float32)
        roofline_step(torch, f"{arch} f32 train step, B 8, S 256", step,
                      args, cfg, "train", 8 * 256)
        if arch == TRAIN_ARCH:
            ms = []
            for _ in range(5):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                out = step(*args)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t1) * 1e3)
                del out
            log(f"phase 27 (b) [{card}] {arch}'s eager f32 step, host ms "
                f"(synchronised, median of 5): {statistics.median(ms):.2f} "
                f"against the {RECORDED_STEP_MS} PERF.md §5 records")
            futs = dryrun_start(pool, tmp.name)
        del params, args
        torch.cuda.empty_cache()
    cfg = get_config("chatglm-6b")
    cap = 1 << (DENSE_MAX_LEN + DENSE_MAX_GEN - 1).bit_length()
    rows = 20
    params = M.init_params(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    cache = M.init_cache(cfg, rows, cap, torch.bfloat16, device="cuda")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (rows,),
                                     generator=gen, device="cuda",
                                     dtype=torch.int32),
             "positions": torch.full((rows,), cap - 1, dtype=torch.int32,
                                     device="cuda")}
    c = roofline_step(
        torch, f"chatglm-6b bf16 padded decode step, {rows} rows at "
        f"{cap} slots", lambda p, k, b: M.decode_step(
            p, cfg, k, b, act_dtype=torch.bfloat16),
        (params, cache, batch), cfg, "decode", rows)
    ms, w, s, kv = padded_step_bound(
        types.SimpleNamespace(cfg=cfg, params=params),
        [types.SimpleNamespace(length=cap)] * rows, cap, 0)
    log(f"phase 27 (b) chatglm-6b decode step bytes: the roofline's "
        f"{c['bytes'] / 1e9:.3f} GB (every op's operands and results) "
        f"against padded_step_bound's {w + s + kv:.3f} GB (weights {w:.3f}"
        f", cache {kv:.3f}; {ms:.3f} ms)")
    del params, cache, batch
    torch.cuda.empty_cache()
    with tmp, pool:
        dryrun_check(futs, tmp.name, total)
    log(f"phase 27: {time.perf_counter() - t0:.1f} s")


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    t_start = time.perf_counter()
    try:
        # 1. device
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        card = smi.stdout.strip().splitlines()[0] if smi.stdout else "?"
        log(card)
        log(f"torch {torch.__version__} cuda {torch.version.cuda} "
            f"device {torch.cuda.get_device_name(0)}")

        # 2. build
        from repro_torch.kernels import build
        t0 = time.perf_counter()
        lib = build.build()
        build.load_library()
        log(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s")
        build_report(build, lib)
        op_host_cost(torch, card)

        log(f"[{time.perf_counter() - t_start:.1f} s] phase 3")
        # 3. kernels against their plain versions
        from repro_torch.kernels.decode_attention import ops, ref
        from repro_torch.kernels.flash_attention import ops as fops
        from repro_torch.kernels.flash_attention import ref as fref
        from repro_torch.kernels.ssd_scan import ops as sops
        from repro_torch.kernels.ssd_scan import ref as sref
        from repro_torch.models import ssm as ssm_module
        from repro_torch.models import transformer
        kernel_checks(torch, ops, ref)
        dense_kernel_checks(torch, fops, fref, ops, ref)
        all_kernels = ops.KERNELS + fops.KERNELS + sops.KERNELS

        def reset_counts():
            ops.reset_counts()
            fops.reset_counts()
            sops.reset_counts()

        def counts(attr):
            # the backward kernel has no plain route: no plain_calls
            return {fn.__name__: getattr(fn, attr, 0) for fn in all_kernels}

        log(f"[{time.perf_counter() - t_start:.1f} s] phase 4")
        # 4. the paged and dense models on the card against the CPU
        model_check(torch, np)
        dense_model_check(torch, np)

        # 9-10. the SSD scan and int8 decode kernels, then their models
        ssm_int8_kernel_checks(torch, sops, sref, ops, ref,
                               transformer._quant_i8)
        ssm_int8_model_checks(torch, np, transformer._quant_i8)

        log(f"[{time.perf_counter() - t_start:.1f} s] phase 5")
        # 5. serve chatglm-6b at full width through the paged engine
        from repro_torch.launch.serve import (run_engine_backend,
                                              run_paged_engine_backend)
        from repro_torch.workload.apps import make_shared_head_dataset
        reqs = make_shared_head_dataset(N_REQUESTS, n_apps=3,
                                        gen_length=GEN_LENGTH, seed=0)
        t0 = time.perf_counter()
        decoded, waves = paged_recorders(transformer, 28)
        with decoded, waves, replays(decoded) as windows:
            reset_counts()
            res = run_paged_engine_backend(
                "chatglm-6b", 0.0, 0.0, "magnus-paged", seed=0,
                reduced=False, device="cuda", dtype=torch.bfloat16,
                prefix_cache=True, requests=reqs, **SERVE)
            launches = counts("launches")
        plain_calls = counts("plain_calls")
        engine = res.pop("engine")
        log(f"serve chatglm-6b full width bf16: "
            f"{time.perf_counter() - t0:.1f} s with set-up; "
            + json.dumps(res))
        log(f"serve kernel launches {launches}, plain calls {plain_calls}, "
            f"{windows.windows} decode windows, {engine.graph_captures} "
            f"capture(s) of the decode step")
        windows.log("paged serve", engine.decode_steps)
        cfg = engine.cfg
        check(cfg.num_layers == 28 and cfg.d_model == 4096,
              "serve did not run chatglm-6b at full width")
        check(res["requests"] == N_REQUESTS,
              f"{res['requests']} of {N_REQUESTS} requests finished")
        engine.assert_drained()
        check(res["prefix_hits"] > 0, "the prefix cache never hit")
        check(all(launches[fn.__name__] > 0 for fn in
                  (ops.paged_decode_attention,
                   ops.paged_prefix_prefill_attention)),
              f"a paged kernel never launched: {launches}")
        check(not any(plain_calls.values()),
              f"plain versions ran on the main path: {plain_calls}")
        check(engine.graph_captures == 1
              and windows.replayed_steps == engine.decode_steps - 1,
              f"{engine.graph_captures} captures of the decode step and "
              f"{windows.replayed_steps} replayed steps of "
              f"{engine.decode_steps}: not one capture, whose warm-up step "
              f"is the first step, and replays for the rest")
        check(launches["paged_decode_attention"]
              == cfg.num_layers * engine.decode_steps
              and launches["paged_prefix_prefill_attention"]
              == cfg.num_layers * engine.prefill_dispatches,
              f"launches {launches} against {engine.decode_steps} steps "
              f"and {engine.prefill_dispatches} waves")
        check(res["host_syncs"] == windows.windows,
              f"{res['host_syncs']} host syncs in {windows.windows} "
              f"windows: not one readback a window")
        for r in reqs:
            toks = engine.generated[r.req_id]
            check(len(toks) == min(r.gen_length, SERVE["max_gen"]),
                  f"request {r.req_id}: {len(toks)} tokens")
            check(all(0 <= t < cfg.vocab_size for t in toks),
                  f"request {r.req_id}: token out of range")
        check(torch.isfinite(engine.logits.float()).all().item(),
              "non-finite logits after serving")
        check(len(decoded.kept) * cfg.num_layers
              == launches["paged_decode_attention"]
              and len(waves.kept) * cfg.num_layers
              == launches["paged_prefix_prefill_attention"],
              f"recorded {len(decoded.kept)} decode steps and "
              f"{len(waves.kept)} waves against launches {launches}")
        log("serve waves (rows, bucket, table width, prefix_lens, "
            "suffix_lens): " + "; ".join(
                f"{tuple(q.shape[:2])} {t.shape[1]} {pl.tolist()} "
                f"{sl.tolist()}" for q, _, _, t, pl, sl in waves.kept))
        served = {"streams": [engine.generated[r.req_id] for r in reqs],
                  "launches": launches, "windows": windows.windows,
                  "host_syncs": res["host_syncs"],
                  "steps": engine.decode_steps,
                  "waves": engine.prefill_dispatches}
        profile_window(torch, engine, make_shared_head_dataset(
            SERVE["max_concurrency"], n_apps=3, gen_length=GEN_LENGTH,
            seed=1))
        pages = engine.pages
        res5 = {k: res[k] for k in ("wall_s", "token_tp")}
        del engine, res, windows   # the recorder holds the pools' views
        torch.cuda.empty_cache()

        log(f"[{time.perf_counter() - t_start:.1f} s] phase 14")
        # 14. phase 5's serve on an engine warmed up ahead of time
        wreqs = make_shared_head_dataset(N_REQUESTS, n_apps=3,
                                         gen_length=GEN_LENGTH, seed=0)
        w = warmed_serve(torch, wreqs, reset_counts, counts)
        wengine = w.pop("engine")
        check(w["captures"] == (1, 1),
              f"captures before and after the warmed serve: "
              f"{w['captures']}, not (1, 1)")
        check(w["stats"]["served"] == N_REQUESTS,
              f"warmed serve finished {w['stats']['served']} requests")
        check([wengine.generated.get(r.req_id) for r in wreqs]
              == served["streams"],
              "the warmed serve's streams differ from phase 5's")
        check(w["launches"] == served["launches"]
              and not any(w["plain_calls"].values()),
              f"warmed serve launches {w['launches']}, plain calls "
              f"{w['plain_calls']}; phase 5: {served['launches']}")
        check(wengine.decode_steps == served["steps"]
              == w["replayed_steps"]
              and w["launches"]["paged_decode_attention"]
              == 28 * served["steps"],
              f"warmed serve: {wengine.decode_steps} steps, "
              f"{w['replayed_steps']} replayed; phase 5: {served['steps']}")
        check(w["stats"]["host_syncs"] == w["windows"]
              == served["host_syncs"],
              f"warmed serve: {w['stats']['host_syncs']} host syncs in "
              f"{w['windows']} windows; phase 5: {served['host_syncs']}")
        wengine.assert_drained()
        log("warmed serve: streams, steps, windows, host syncs and "
            "launches equal phase 5's, no capture during the serve")
        graphed = profile_window(torch, wengine, make_shared_head_dataset(
            SERVE["max_concurrency"], n_apps=3, gen_length=GEN_LENGTH,
            seed=1), eager=True)
        log_profiles("decode step at 32 rows", graphed)
        streams5 = served["streams"]
        sched5 = {k: served[k] for k in ("steps", "waves", "host_syncs")}
        del wengine, w, served
        torch.cuda.empty_cache()

        log(f"[{time.perf_counter() - t_start:.1f} s] phase 6")
        # 6. paged timings at the serve's shapes
        spin = spin_ms(torch)
        log(f"spin kernel: {spin:.2f} ms")
        t = {"paged_decode_attention": summarize(
                 "paged_decode_attention", *time_decode(
                     torch, ops, ref, decoded.kept, pages["k"],
                     pages["v"], spin)),
             "paged_prefix_prefill_attention": summarize(
                 "paged_prefix_prefill_attention", *time_prefill(
                     torch, ops, ref, waves.kept, pages["k"],
                     pages["v"], spin))}
        paged_launches = launches
        del pages, decoded, waves
        torch.cuda.empty_cache()

        log(f"[{time.perf_counter() - t_start:.1f} s] phase 7")
        # 7. serve chatglm-6b at full width through the padded BatchEngine
        from repro_torch.workload.generator import poisson_workload
        dreqs = poisson_workload(8, 60, seed=0, max_len=DENSE_MAX_LEN,
                                 max_gen=DENSE_MAX_GEN)[:DENSE_N_REQUESTS]
        targets = {r.req_id: min(r.gen_length, DENSE_MAX_GEN) for r in dreqs}
        hbm = torch.cuda.get_device_properties(0).total_memory
        t0 = time.perf_counter()
        dprefill, ddecode = dense_recorders(transformer, 28)
        with dprefill, ddecode, replays(ddecode) as drep:
            reset_counts()
            dres = run_engine_backend(
                "chatglm-6b", 0.0, 0.0, "magnus", seed=0, reduced=False,
                device="cuda", dtype=torch.bfloat16, hbm_bytes=hbm,
                max_len=DENSE_MAX_LEN, max_gen=DENSE_MAX_GEN,
                requests=dreqs)
            dlaunches = counts("launches")
        dplain = counts("plain_calls")
        dengine, results = dres.pop("engine"), dres.pop("results")
        log(f"padded serve chatglm-6b full width bf16 magnus: "
            f"{time.perf_counter() - t0:.1f} s with set-up; "
            + json.dumps(dres))
        log(f"padded serve batches (size, batch length, G(B), host "
            f"syncs): " + "; ".join(
                f"({r.batch_size}, {r.batch_length}, {r.iterations}, "
                f"{bin(r.iterations).count('1')})" for r in results))
        log(f"padded serve kernel launches {dlaunches}, plain calls "
            f"{dplain}")
        dcfg = dengine.cfg
        check(dcfg.num_layers == 28 and dcfg.d_model == 4096,
              "padded serve did not run chatglm-6b at full width")
        check(dres["requests"] == DENSE_N_REQUESTS,
              f"{dres['requests']} of {DENSE_N_REQUESTS} requests served")
        served_ids = [rid for r in results for rid in r.generated]
        check(sorted(served_ids) == sorted(targets),
              "the batches did not serve each request once")
        for r in results:
            check(r.iterations == max(targets[i] for i in r.generated),
                  f"a batch ran {r.iterations} iterations, not its G(B)")
            for rid, toks in r.generated.items():
                check(len(toks) == targets[rid],
                      f"request {rid}: {len(toks)} of {targets[rid]} tokens")
                check(all(0 <= x < dcfg.vocab_size for x in toks),
                      f"request {rid}: token out of range")
        steps = sum(r.iterations for r in results)
        check(dres["host_syncs"] == sum(bin(r.iterations).count("1")
                                        for r in results),
              f"host syncs {dres['host_syncs']}: not one per window")
        check(dlaunches["flash_attention"] == 28 * len(results),
              f"flash launches {dlaunches['flash_attention']} != 28 x "
              f"{len(results)} batches")
        check(dlaunches["decode_attention"] == 28 * steps,
              f"decode launches {dlaunches['decode_attention']} != 28 x "
              f"{steps} decode steps")
        check(ddecode.steps == steps,
              f"recorded {ddecode.steps} decode steps, not {steps}")
        check_captures("padded serve", dengine, results, drep, steps)
        check(not any(dplain.values()),
              f"plain versions ran on the padded path: {dplain}")
        kept = sum(t.nbytes for c in dprefill.kept + ddecode.kept for t in c)
        log(f"padded serve kept {len(dprefill.kept)} prefills and "
            f"{len(ddecode.kept)} decode steps ({kept / 2 ** 30:.2f} GiB)")
        big = max(results, key=lambda r: r.batch_size)
        log_profiles(f"padded decode step at {big.batch_size} rows",
                     profile_dense_window(
                         torch, dengine,
                         [r for r in dreqs if r.req_id in big.generated],
                         big.batch_length, 1 << (big.batch_length
                                                 + big.iterations
                                                 - 1).bit_length()))
        res7 = {k: dres[k] for k in ("wall_s", "token_tp")}
        del dengine, dres, results, drep   # drep: the last batch's cache
        torch.cuda.empty_cache()

        log(f"[{time.perf_counter() - t_start:.1f} s] phase 8")
        # 8. padded timings at the serve's shapes
        t["flash_attention"] = summarize(
            "flash_attention", *time_flash(torch, fops, fref,
                                           dprefill.kept, spin))
        t["decode_attention"] = summarize(
            "decode_attention", *time_dense_decode(torch, ops, ref,
                                                   ddecode.kept, spin))
        del dprefill, ddecode
        torch.cuda.empty_cache()

        log(f"[{time.perf_counter() - t_start:.1f} s] phase 11")
        # 11. serve mamba2-780m at full width through the padded
        # BatchEngine, on phase 7's requests
        slaunches, scans, res11 = ssm_serve(torch, ssm_module, hbm,
                                            reset_counts, counts)
        torch.cuda.empty_cache()

        log(f"[{time.perf_counter() - t_start:.1f} s] phase 12")
        # 12. an int8 decode window of chatglm-6b at full width
        i8launches, i8calls = int8_window(torch, np, transformer, ref,
                                          reset_counts, counts)
        torch.cuda.empty_cache()

        log(f"[{time.perf_counter() - t_start:.1f} s] phase 13")
        # 13. timings of the scan and the int8 kernel at the kept inputs
        t["ssd_scan"] = summarize(
            "ssd_scan", *time_scan(torch, sops, sref, scans, spin))
        t["decode_attention_int8"] = summarize(
            "decode_attention_int8", *time_int8(torch, ops, ref, i8calls,
                                                spin))
        del scans, i8calls
        torch.cuda.empty_cache()

        log(f"[{time.perf_counter() - t_start:.1f} s] phase 15")
        # 15. the chaos serve: the lifecycle and the host swap tier
        from repro_torch.models import model as M
        cparams = M.init_params(cfg, seed=0, device="cuda",
                                dtype=torch.bfloat16)   # phase 5's weights
        t0 = time.perf_counter()
        chaos = chaos_serve(torch, cfg, cparams, "cuda", torch.bfloat16,
                            reset_counts, counts)
        log(f"chaos serve chatglm-6b full width bf16: "
            f"{time.perf_counter() - t0:.1f} s; launches "
            f"{chaos['launches']}, plain calls {chaos['plain_calls']}")
        guard = check_chaos(torch, chaos, cfg.num_layers)
        hold_chaos(torch, ops, ref, chaos)
        ceng = chaos["engine"]
        chaos16 = {"reqs": chaos["reqs"], "generated": ceng.generated,
                   "shapes": chaos["shapes"], "sheds": shed_list(chaos),
                   "counters": {n: getattr(ceng, n) for n in (
                       "decode_steps", "prefill_dispatches", "evictions",
                       "quarantined", "deadline_misses", "stall_ticks",
                       "swap_outs", "swap_ins", "swapped_blocks",
                       "host_syncs")}}
        log_chaos(chaos, guard, res5["wall_s"], res5["token_tp"])
        del chaos, ceng
        torch.cuda.empty_cache()
        quarantine_check(torch, cfg, cparams, "cuda", torch.bfloat16)
        torch.cuda.empty_cache()
        swap_roundtrip_check(torch, cfg, cparams, "cuda", torch.bfloat16)
        del cparams
        torch.cuda.empty_cache()
        shapes5, cmp32, wall32, streams32 = f32_witness(
            torch, cfg, reset_counts, counts, sched5, chaos16)
        cmp16 = compare_streams(chaos16["reqs"], chaos16["generated"],
                                chaos16["shapes"], reqs, streams5, shapes5)
        log_streams([("bf16 (phase 5's)", cmp16),
                     ("f32 (the witness)", cmp32)])
        log(f"f32 witness: chaos serve {wall32:.2f} s, counters and sheds "
            f"equal the bf16 chaos serve's")
        check(not cmp16[3], f"streams {cmp16[3]} differ from phase 5's "
              f"though their KV has phase 5's lineage")
        check(cmp32[0] == len(chaos16["generated"]),
              f"in f32, chaos streams {cmp32[1] + cmp32[2] + cmp32[3]} "
              f"differ from the unfaulted serve's")
        del chaos16
        torch.cuda.empty_cache()

        log(f"[{time.perf_counter() - t_start:.1f} s] phase 16")
        # 16. speculative decoding: the draft-and-verify window as one
        # captured graph
        spec_phase(torch, ops, ref, cfg, reqs, streams5, shapes5, streams32,
                   res5, spin, reset_counts, counts)

        log(f"[{time.perf_counter() - t_start:.1f} s] phase 17")
        # 17. kill and recover: the snapshot, the journal and the
        # restore in place under the captured decode graph
        t17 = recovery_phase(torch, ops, ref, cfg, reqs, streams5, shapes5,
                             sched5, res5, spin, reset_counts, counts)
        log("phase 17 kernels (mean of per-shape medians, CUDA events, ms): "
            + json.dumps({"paged_decode_attention on the restored pool": {
                key: (round(v, 4) if isinstance(v, float) else v)
                for key, v in t17.items()}}))

        log(f"[{time.perf_counter() - t_start:.1f} s] phase 18")
        # 18. olmoe-1b-7b's MoE paged serve at full width, its capacity
        # dispatch inside the captured decode graph
        t18, moe_launches = moe_phase(torch, ops, ref, transformer, res5,
                                      spin, reset_counts, counts)
        log("phase 18 kernels at olmoe-1b-7b's inputs (mean of per-shape "
            "medians, CUDA events, ms): " + json.dumps({
                name: {"launches": moe_launches[name], **{
                    key: (round(v, 4) if isinstance(v, float) else v)
                    for key, v in row.items()}}
                for name, row in t18.items()}))

        log(f"[{time.perf_counter() - t_start:.1f} s] phase 19")
        # 19. hymba-1.5b's hybrid padded serve at full width, its
        # attention and SSM heads under the captured decode graph, and
        # the sliding window at a 4,096-token prefill
        t19, hybrid_launches = hybrid_phase(
            torch, ops, ref, fops, fref, sops, sref, ssm_module,
            transformer, hbm, spin, {"phase 7 chatglm-6b": res7,
                                     "phase 11 mamba2-780m": res11},
            reset_counts, counts)
        log("phase 19 kernels at hymba-1.5b's inputs (mean of per-shape "
            "medians, CUDA events, ms): " + json.dumps({
                name: {"launches": hybrid_launches.get(name), **{
                    key: (round(v, 4) if isinstance(v, float) else v)
                    for key, v in row.items()}}
                for name, row in t19.items()}))

        log(f"[{time.perf_counter() - t_start:.1f} s] phase 20")
        # 20. deepseek-v3-671b's MLA padded serve at its published
        # widths (2 layers, no MTP), its absorbed decode and capacity
        # dispatch under the captured decode graph
        from repro_torch.models import mla as mla_module
        mla_launches = mla_phase(torch, transformer, mla_module, hbm,
                                 {"phase 7 chatglm-6b": res7},
                                 reset_counts, counts)
        log(f"phase 20 kernel launches: {mla_launches}")

        log(f"[{time.perf_counter() - t_start:.1f} s] phase 21")
        # 21. internvl2-26b's vlm padded serve uncut, its 256-patch
        # prefix in every prefill and decode cache
        t21, vlm_launches = vlm_phase(
            torch, ops, ref, fops, fref, transformer, hbm, spin,
            {"phase 7 chatglm-6b": res7}, reset_counts, counts)
        log("phase 21 kernels at internvl2-26b's inputs (mean of per-shape "
            "medians, CUDA events, ms): " + json.dumps({
                name: {"launches": vlm_launches.get(name), **{
                    key: (round(v, 4) if isinstance(v, float) else v)
                    for key, v in row.items()}}
                for name, row in t21.items()}))

        log(f"[{time.perf_counter() - t_start:.1f} s] phase 22")
        # 22. whisper-large-v3's enc-dec padded serve uncut: its encoder
        # and cross-attention prefill through the flash kernel's full
        # mode with a key bound, both decode attentions through the
        # dense decode kernel, under the captured decode graph
        t22, encdec_launches = encdec_phase(
            torch, np, ops, ref, fops, fref, hbm, spin,
            {"phase 7 chatglm-6b": res7}, reset_counts, counts)
        log("phase 22 kernels at whisper-large-v3's inputs (mean of "
            "per-shape medians, CUDA events, ms): " + json.dumps({
                name: {"launches": encdec_launches.get(name.split()[0]),
                       **{key: (round(v, 4) if isinstance(v, float) else v)
                          for key, v in row.items()}}
                for name, row in t22.items()}))

        log(f"[{time.perf_counter() - t_start:.1f} s] phase 23")
        # 23. training: the flash kernel's backward, then smollm-135m at
        # full width through launch/train.py
        t["flash_attention_bwd"], train_launches = train_phase(
            torch, np, fops, fref, spin, reset_counts, counts)

        log(f"[{time.perf_counter() - t_start:.1f} s] phase 24")
        # 24. training the SSM and hybrid families: the scan's backward
        # kernel, then mamba2-780m and hymba-1.5b uncut
        t["ssd_scan_bwd"], scan_train_launches = ssm_train_phase(
            torch, np, fops, sops, sref, spin, reset_counts, counts)

        log(f"[{time.perf_counter() - t_start:.1f} s] phase 25")
        # 25. the lint's sweep, then the six counted sync sites under
        # REPRO_SANITIZE=1 and PyTorch's sync detector
        sync_phase(torch, src)

        log(f"[{time.perf_counter() - t_start:.1f} s] phase 27")
        # 27. the dry run and the roofline: launch/dryrun.py --all and
        # launch/hillclimb.py on the fake 512-rank group, then three
        # full-width steps against their dry runs.  Before phase 26: the
        # f32 weights phase 26 shares with its ranks by CUDA IPC stay
        # allocated in this process after the ranks exit
        roofline_phase(torch, card)

        log(f"[{time.perf_counter() - t_start:.1f} s] phase 26")
        # 26. context-parallel decode: qwen2.5-14b at decode_32k on one
        # device with decode_cp, then on two ranks of one card over gloo
        cp_rows, cp_launches, _ = cp_phase(
            torch, ops, ref, spin, reset_counts, counts)
        t.update(cp_rows)

        source = {"paged_decode_attention":
                  ("src/repro_torch/csrc/paged_decode_attention.cu",
                   "src/repro/kernels/decode_attention/kernel.py:298",
                   paged_launches),
                  "paged_prefix_prefill_attention":
                  ("src/repro_torch/csrc/paged_prefix_prefill_attention.cu",
                   "src/repro/kernels/decode_attention/kernel.py:225",
                   paged_launches),
                  "flash_attention":
                  ("src/repro_torch/csrc/flash_attention.cu",
                   "src/repro/kernels/flash_attention/kernel.py:76",
                   dlaunches),
                  "decode_attention":
                  ("src/repro_torch/csrc/decode_attention.cu",
                   "src/repro/kernels/decode_attention/kernel.py:402",
                   dlaunches),
                  "decode_attention_int8":
                  ("src/repro_torch/csrc/decode_attention.cu",
                   "src/repro/kernels/decode_attention/kernel.py:345",
                   i8launches),
                  "ssd_scan":
                  ("src/repro_torch/csrc/ssd_scan.cu",
                   "src/repro/kernels/ssd_scan/kernel.py:76",
                   slaunches),
                  "flash_attention_bwd":
                  ("src/repro_torch/csrc/flash_attention_bwd.cu",
                   "none: the JAX package differentiates its plain jnp "
                   "attention (src/repro/models/attention.py:26)",
                   train_launches),
                  "ssd_scan_bwd":
                  ("src/repro_torch/csrc/ssd_scan_bwd.cu",
                   "none: the JAX package differentiates its plain jnp "
                   "scan (src/repro/models/ssm.py:53)",
                   {"ssd_scan_bwd": scan_train_launches}),
                  "decode_attention_partial":
                  ("src/repro_torch/csrc/decode_attention.cu",
                   "none: the reference computes the shard's partial in "
                   "plain jnp inside shard_map "
                   "(src/repro/models/attention.py:83)",
                   cp_launches),
                  "decode_attention_int8_partial":
                  ("src/repro_torch/csrc/decode_attention.cu",
                   "none: the reference dequantises the int8 cache, then "
                   "computes the shard's partial in plain jnp inside "
                   "shard_map (src/repro/models/attention.py:83, "
                   "src/repro/launch/hillclimb.py:98)",
                   cp_launches)}
        rows = []
        for name, (path, tpu, count) in source.items():
            rows.append({"name": name, "route": "cuda", "source": path,
                         "replaces": tpu, "launches": count[name],
                         **t[name]})
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"kernels": rows}))
    except Exception as e:  # every phase is fatal: report and fail
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
