"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py pipeline   # phases 1, 2 and 29 alone (e.g. on four cards)
    python3 chip_smoke.py head128    # phases 1, 2 and 30 alone
    python3 chip_smoke.py options    # phases 1, 2 and 31 alone
    python3 chip_smoke.py sp_model   # the SP cost model's constants (four cards)

Phases, one line each; any failure raises and the exit code is non-zero:
  1. device: requires CUDA, prints the card's name and power limit;
  2. build: compiles the CUDA kernels and the native scheduler from this
     checkout's sources, all at once (quantizedattention_tpu_torch/_build.py),
     holds the flash forward's (bf16 and fp32 modes at head dims 64 and
     128) and backward's (fast at 64 and 128), B10 exact's,
     B4's, the int8 forward's and backward's (at 64 and 128), B1 fp32's and
     B9, B11 and B12 fast's (at 64 and 128), the decode kernel's (its int8
     instances, B13/B14, and its int4 ones, B15/B16, at 64 and 128) and the
     weight matmuls' shared bytes against their launch
     geometry (ops/flash_tiling.py, ops/jvp_tiling.py, ops/int8_tiling.py,
     parallel/decode_tiling.py, ops/linear_tiling.py), and fails if ptxas
     spills or serializes wgmma (a C75xx note) in the flash forward (both
     modes) or backward, in B5, B7 and B8 (both head dims), in B9, B11 and
     B12 fast and their preps, in B10 exact, its prep and its merge, or
     spills in any decode instance or in B4 (whose cluster geometry is held
     against ops/int8_tiling.py);
  3. flash_fwd kernel vs its plain PyTorch version (O and lse) on f32 and on
     bf16 inputs, at the forward's cases and its tile edges (t and s off a
     multiple of 128, causal t < s and t > s, rep 3, 5, 8 and 128, one token,
     rows with no visible key in a tile, more key tiles than ring stages);
     each call twice for the same bits, the f32 path equal to the bf16 path
     bit for bit on bf16-representable inputs, strided [b, t, h, d] views
     equal to contiguous ones, and the f32 K/V prep byte-equal to
     .to(bfloat16); then timed at the serving prefill's shape;
  4. the slotted int8 decode kernel (B13) vs its plain version, with stale
     non-finite scales and junk payloads written past every row's length;
     timed at the serving decode shape and at capacity (1280 of 1280, 16/16
     and 16/4 heads) beside its bound;
  5. serving at full width: the bench LM (vocab 8192, d_model 1024, 16 heads,
     head_dim 64, 4 layers, max_seq 1280, bf16) serves 8 requests of 256
     random tokens x 96 new tokens through ServingEngine (8 slots, decode
     horizon 32), after a warm-up run. The timed run must launch both
     kernels, repeat the warm-up's tokens, and match `generate` on the same
     8 prompts as one batch; prefill logits must agree with the plain path
     on the CPU;
  6. flash_bwd: the dK/dV (B2) and dQ (B3) kernels vs their plain versions in
     fast and exact mode (O and lse from the B1 kernel), each called twice
     for the same bits, on the forward's cases, a few edge shapes, the fast
     kernels' tile edges (t and s off a multiple of 128, causal t < s and t >
     s, rep 3, 5, 8 and 128, one 128-key tile, more q and key tiles than ring
     stages), the one-token case on 16 more draws and the train-GQA phase's
     shape (8, 4 q / 2 kv, 512, 64); at each, fast mode's
     prep launch against the plain prep (q_s, dO_s, lse, K and V byte-equal,
     D within 1e-6 of max|D|) and the whole fast call on [b, t, h, d] views
     equal bit for bit to contiguous inputs; then autograd through
     flash_attention_bf16 against the fp32 oracle within the JAX package's
     envelope;
  7. the training shape (4, 16, 2048, 64), causal: B1, B2 and B3 (both
     modes) held against their plain versions, then timed beside them and
     beside F.scaled_dot_product_attention (a yardstick only; the port never
     calls it); B1's f32 call split into its K/V prep launch and its kernel,
     and the call on bf16 inputs (no prep); the whole fast backward call on
     the model's f32 [b, t, h, d] views, its prep launches held against the
     plain prep and the call against its plain version there, then timed
     with its prep launches and the plain prep; B2 and B3 at
     GQA rep 4 (2, 16 q / 4 kv, 2048, 64) beside SDPA's backward there;
  8. int8 kernels: B4 byte-equal to its plain version (payloads and
     scales) on [b, h, t, 64] f32 views of [b, t, h, 64] tensors and on
     bf16, at grains 128, 256, 512 and 1024 with a partial last grain, and
     on one launch of three jobs at three grains; B4 (quantize, byte-equal), B5 (forward), B7 (dK/dV) and
     B8 (dQ) against their plain versions at the training shape, a ragged
     length with a large K mean, GQA rep 4, the GQA train shape (rep 2), the
     int8 serving prefill's shape (8, 16, 256, 64) and an odd cross length, with B8's K-smoothing term held on its own where
     the K mean is large, and the forward's tile edges (t and s off a
     multiple of 128, causal t < s, rep 3 and 5, one 128-key tile, rows with
     no visible key in a tile); B4, B5, B7 and B8 called twice on each
     case's operands for the same bits; then each timed at (4, 16, 2048, 64) causal
     beside its plain version (B4 also on the model's f32 views and on
     bf16, as B6 launches it), and B7 and B8 also at GQA rep 4 (2, 16 q / 4
     kv, 2048, 64), each with its bound and TFLOP/s (bf16-equivalent
     products over time) and the pair beside SDPA's bf16 backward at the same
     shape (K/V repeated over the group; a yardstick only);
  9. sage_attention_int8 at (4, 16, 2048, 64) causal against the fp32
     oracle by the JAX package's criteria, with the tiny-magnitude causal
     case and K-smoothing against the raw int8 path;
 10. train at full width, with bf16 and then with int8 attention from the
     same init: the bench LM's widths at max_seq 2048 with f32 params,
     4 x 2048 tokens, 1 warm-up + 10 timed AdamW steps through
     make_train_step; losses finite and falling; each step launches its
     attention kind's kernels (B1/B2/B3 and the backward's prep launch, or
     B4/B5/B7/B8) n_layers times and
     the other kind's never; lm_loss gradients on the card vs the CPU plain
     path; torch.profiler over one more step (device time by kernel, busy
     share, the attention kernels' share); the int8 run's global gradient
     norm within 2x of the bf16
     run's at every step (BASELINE config 4);
 11. train GQA: the entry() config (4 q / 2 kv heads), 8 x 512 tokens, 10
     steps, with bf16 and with int8 attention; losses finite and falling,
     the dK/dV kernels run with rep 2;
 12. the fused int8 inference kernel (B6) against its plain version (bf16
     and f32 inputs at (4, 16, 2048, 64) causal, a ragged length with a
     large K mean, GQA rep 4, an odd cross length, rep 3, one token and phase
     8's tile edges), and against B4 then B5 on the same inputs up to 8192
     tokens (lse equal);
 13. sage_attention_int8_inference at (4, 16, 2048, 64) against the fp32
     oracle with bench.py's gate, and with a K offset of 8 (smoothing);
 14. BASELINE config 3: sage_attention_int8_inference at (4, 16, {2048,
     4096, 8192}, 64) causal on bf16 inputs (the path run whose B6 launches
     are counted), then B6 timed (and split into its Q/K/V quantize launch and
     its mainloop) beside SDPA bf16, B4 -> B5 and B1 on the same inputs, and
     at the GQA shape (4, 16 q / 4 kv, 4096, 64);
 15. the weight-only int8 (B17) and int4 (B18) matmuls against their plain
     versions at decode (m = 8), spec verify (m = 40) and prefill (m = 2048)
     rows of the bench widths and an odd shape, each called twice for the
     same bits, then timed beside the bf16 GEMM they replace (GB/s and the
     share of HBM's rate where they stream, TFLOP/s at prefill);
 16. quantized serving at full width, as phase 5, with attention="int8"
     (prefill through B4 + B5, never B1), with weight_quant="int8" (every
     projection and the unembedding through B17) and with
     weight_quant="int4" (B18); each repeats its warm-up, matches
     `generate` on its own params and the CPU plain path's prefill logits;
     two bf16 runs bracket them, and each is compared with their mean;
 17. the JVP family against its plain versions: B1's fp32 mode, B9 (O, tO,
     lse, mu), B10 (tO given O and lse), B11 (dK, dV, dtK, dtV) and B12
     (dQ, dtQ), B9-B12 in fast and exact mode, at (2, 4, 1024, 64) causal
     and not, the DiT's attention shape (4, 4, 4096, 64), 77x201 causal and
     not, (1, 3, 33, 130) causal and not, and one token, and B1 fp32 at GQA
     rep 4 (2, 8 q / 2 kv, 300, 64) causal and at its tile edges (t > s and
     t < s causal, rep 3, one query, one key); B1 fp32, B9, B11 and B12 fast
     called twice for the same bits at each (B9's second call on [b, t, h,
     d] views, B12's on a prep of its own), and their prep launches (B1's
     K/V split, B9's bf16 K, V, tK, tV from the strided views, the bf16
     operands and row terms B11 and B12 share) byte-equal to the plain
     preps; B10 exact on the DiT's [b, h, t, d] views of [b, t, h, d]
     tensors at the DiT's shape and the dit_jvp path's (2, 4, 512, 64),
     whose keys it splits, against its plain version and bit-equal on a
     second call, its prep byte-equal to the plain prep;
 18. BASELINE config 5's gate: attention_value_and_jvp (exact) and
     torch.func.jvp of attention_jvp at (1, 2, 4096, 64) against the fp32
     oracle's (O, tO), 0 mismatches at atol 1e-2; at (1, 2, 256, 64),
     causal and not, the gradients of a loss over (O, tO) and of
     attention_jvp against autograd through the oracle; fast against
     exact;
 19. timing of B1 fp32 (beside F.scaled_dot_product_attention on the same
     f32 inputs; its bounds as 3xTF32 on the tensor cores and as fp32 on
     the CUDA cores) and B9-B12 in both modes, at the DiT's attention shape
     (4, 4, 4096, 64) beside their plain versions and at bench.py's
     bench_jvp shape (4, 16, 4096, 64), non-causal, on [b, h, t, d] views
     of [b, t, h, d] tensors as the DiT hands them; B1 fp32's, B9 fast's and
     B11 fast's calls split into their prep launch and the kernel, B12 fast
     on B11's prep (as the rCM step runs it) and as a call of its own; B10
     exact also at the dit_jvp path's shape (2, 4, 512, 64), with its bound
     as 3xTF32 on the tensor cores beside the fp32 CUDA cores' at each
     shape;
 20. the rCM distillation step of the DiT at BASELINE config 5
     (DiTConfig(seq_len=4096): d_model 256, 4 heads, 2 layers; batch 4;
     `ada` and `out` drawn at 1/sqrt(fan_in), so attention reaches the
     loss), fast=True: 1 warm-up + 5 AdamW steps through make_dit_rcm_step,
     losses finite and falling, each step launching B1 fp32, B9, B11 and
     B12 and the prep launches of B1 fp32, B9 and B11 (shared with B12)
     n_layers times and no other kernel; step time, tokens/s and peak
     memory; torch.profiler over one more step; at seq 512 the loss and
     every gradient against the CPU plain path, (u, du/dt) against finite
     differences, and torch.func.jvp of dit_forward through B10.
 21. the cache-kind decode kernels: B14 (paged int8), B15 (slotted int4) and
     B16 (paged int4) against their plain versions at the bench widths (16/16
     and 16/4 heads, pages of 128, 10 per sequence) with lengths [0, 1, 127,
     128, 1000, 1280, 300, 640], pages shuffled across the pool, page 0 and
     every page past a row's length holding junk payloads and NaN/inf
     scales; B14 against B13 and B16 against B15, bit for bit, on the same
     K/V; then each timed at the serving decode shape (8 slots x 16 heads,
     length 304 of 1280) beside B13 and its plain version, and B14, B15 and
     B16 at capacity (1280 of 1280) at 16/16 and 16/4 heads beside their
     bounds;
 22. cache-kind serving at full width: phase 5's run with cache="paged"
     (tokens equal phase 5's; B1 and B14 only), kv_quant="int4" (B1 and
     B15), both (tokens equal the slotted int4 run's; B1 and B16), and the
     paged pool cut to 13 pages, so four requests fit at once: admission
     requeues, pages are recycled while banks are in flight, the tokens
     still equal phase 5's and every page is free at the end. Two bf16
     slotted runs bracket them for tokens/s. Every serving run (phases 5,
     16, 22) also holds one decode step's logits on its final cache state
     against the plain path on the CPU.
 23. the verify staircase (spec > 1) of B13-B16 against the plain versions,
     spec 2 and 5, at 16/16 and 16/4 heads, phase 21's shuffled pages, junk
     pages and NaN/inf scales, with lengths [0, 1, 3, 129, 257, 1000, 1280,
     640] (rows shorter than spec, len % 128 < spec, full capacity); every
     query row j bit-equal to the spec = 1 launch at its own length
     len - spec + 1 + j; then each timed at 8 slots x 16 heads x spec 5,
     length 304 of 1280, beside its spec = 1 time and its plain version;
 24. speculative serving at bench.py:bench_spec_decode's widths (the bench
     LM at max_seq 512, bf16; 8 periodic prompts of 256 tokens, 16-token
     motifs, 96 new tokens each): first one verify pass of 5 tokens a slot
     equals 5 decode steps bit for bit (logits and caches, slotted int8 and
     int4); then the plain engine at decode horizon 32 and
     spec_decode=4 on each cache kind (slotted int8, paged int8, slotted
     int4, paged int4), each a warm-up and a timed run that repeats it. Spec
     tokens equal the plain engine's (a difference is printed, and fails
     unless the plain run's top-2 logit gap there, read in f32 from an exact
     replay of that run, is below 1e-2 or one bf16 ulp of its top logit,
     whichever is larger); drafts are
     accepted; a spec run launches B1 and its kind's verify kernel, n_layers
     times per spec step, and no other decode kernel; one verify step's
     logits on the final cache state agree with the CPU plain path.
 25. chunked and prefix serving: B1 at a chunk's shapes against its plain
     version (causal (1, 16, 256, 64) bf16; non-causal from that bf16 q to
     f32 dequantized prefixes of 256, 512 and 768 tokens, the kv_to_bf16
     route), `_merge_partials` on the card against the CPU within 1e-6, B1
     timed at the 768-token prefix beside its plain version and SDPA; the
     bench LM at max_seq 1280 with prefill_chunk=256 and decode horizon 32
     serving 4 prompts of 256 tokens and 4 of 1000 (alternating), 96 new
     tokens each, on each cache kind: one long prompt's last-chunk logits
     against the CPU plain path, B1 launched 7 times a layer for a long
     prompt and once for each one-shot prefill, decode banks between every
     two chunks of every long prompt, tokens set beside the one-shot
     engine's (reported, not gated); bench.py:bench_prefix_cache's traffic
     (paged, pages of 128, chunks of 256, max_seq 1088, 8 x (768 shared +
     64 tail), 32 new tokens, two waves, scheduler="native") cold and warm:
     warm tokens equal cold ones bit for bit, wave 2 hits 48 pages, B1
     launches 224 a cold wave and 64 for the warm wave 2, tokens/s and
     median TTFT of both; `_filter_logits` on the card equal to the CPU's,
     top_k=1 at temperature 1 serving the greedy engine's tokens (f32
     params), a top-k / top-p engine repeating itself under its seed, and
     adaptive_horizon=32 serving phase 5's tokens.
 26. mesh serving: ServingEngine(mesh=make_attention_mesh(data=2, model=2))
     on phase 5's model and requests (8 slots, horizon 32). First, on card
     0, B1, B13-B16 and B13's verify at one rank's shapes (4 slots, 8 q / 8
     kv heads, one 256-token prompt) against their plain versions and timed
     (B17's shards are in phase 15's WEIGHT_SHAPES). Then 4 ranks
     spawned by parallel/launch.py:RankPool, one a card over NCCL where 4
     cards are visible, else sharing the visible card over gloo on CUDA
     tensors (the backend is printed); each rank loads the kernels phase 2
     built. With f32 params the slotted, int4-KV, paged and spec_decode=4
     runs give the one-device engine's tokens on every request; the bf16
     and int8-weight runs print their share of equal tokens and fail where
     a request first differs away from a near-tie of the one-device run
     (MESH_TIE_ULPS); every rank records the same tokens; launches summed
     over the ranks by path. The bf16 run is timed beside the one-device
     engine (tokens/s; with ranks sharing a card not a scaling number) and
     torch.profiler reads one decode step of 8 live slots on rank 0 (the
     all_reduces' host time, collective kernels' and copies' device time).
     Then
     context_sharded_decode at context 4 (B13 with its lse on each rank's
     320 tokens, merged over context) within DECODE_TOL of B13 over the
     whole cache, and the serving half of the JAX package's
     dryrun_multichip (sharded decode, int8 weights over the int4 cache,
     sharded verify).
 27. sequence-parallel training: first, on card 0, B1 and B2/B3 fast with the
     global q/k offsets at the SP paths' shard shapes (SP_KERNEL_CASES: the
     all-gather launch, the ring's diagonal and past steps, GQA 8/2, offsets
     off the tile grid, and rows that see no key, which must give O = 0,
     lse = -inf and zero gradients exactly) against their plain versions,
     timed beside their bounds and SDPA (without a dense mask where a fused
     backend computes the case: is_causal, causal_lower_right, no mask;
     enable_gqa; the dense-mask time beside it). Then
     make_sharded_train_step at TRAIN_CFG's full width on 4 ranks (RankPool,
     as phase 26; models/sharded_jobs.py): ring (bf16 3 steps, int8 2),
     all-gather, zigzag (bf16, int8) on (data 1, model 2, context 2),
     Ulysses (bf16, int8) on (2, 1, 2), and the default attention_sp="auto"
     (bf16, int8) on (1, 2, 2), which must pick and run the resolver's
     strategy for that mesh (models/sharded_train.py:resolve_attention_sp,
     under parallel/scaling_model.py's H100 constants) with the named run's
     launches a step. Every rank's first loss equals rank
     0's, every kernel of the path launches, and each run's first loss and
     gradients hold against the one-device make_train_step of its attention
     kind (bf16: SP_LOSS_REL, SP_GRAD_REL_L2; int8: SP_INT8_LOSS_REL,
     SP_INT8_GRAD_REL_L2 of the strategy run); a witness reads the one-device gradient from the
     batch in two halves against the whole batch's; step times, and one
     profiled ring step's device busy share on rank 0. Then the training half of the JAX dryrun_multichip
     (sharded_jobs.dryrun_training) must give finite losses. B5, B7 and B8
     with the global offsets too (SP_INT8_CASES: the int8 all-gather launch,
     GQA 8/2, offsets off the grid, the KV-sharded launch, rows that see no
     key, exact; a past ring piece bit-equal to the same piece non-causal)
     against their plain versions, timed beside bounds and SDPA; the int8
     all-gather train run (SP_INT8_GRAD_REL_L2["allgather"]); and the int8
     KV-sharded forward on 4 ranks against one device's computation of the
     same per-shard partials and merge.
 28. sequence-parallel rCM distillation: make_dit_rcm_step(mesh=) at
     DIT_CFG's full width (seq 4096, d_model 256, 4 heads x 64, 2 layers,
     batch 4, fast) on (data 1, model 1, context 4), 4 ranks as phase 27,
     2 steps: every rank's loss equals rank 0's, the first loss within
     SP_RCM_LOSS_REL of the one-device step's (its prepass runs the bf16
     ring, the one-device step's fp32 B1), the gradients' relative L2 to
     the one-device step's printed, step times, and the launches of B1 (the
     prepass's ring), B9, B11 and B12 over the ranks.
 29. pipeline-parallel training, checkpoint and failure detection: B1 and
     B2 + B3 at the pipeline's microbatch shape (1, 16, 2048, 64) causal
     against their plain versions, timed beside their bounds and SDPA
     (is_causal); make_pipeline_train_step at TRAIN_CFG's full width on
     phase 27's ranks as a 4-stage pipe mesh (one block a stage, 4
     microbatches; NCCL with a card a rank, else gloo sharing the card):
     bf16 3 steps (median step printed) and int8 1 step, every rank's loss
     and replicated leaves equal, the first loss and gradients against the
     one-device step of the same attention kind (phase 27's SP bounds),
     launches over the ranks exactly B1 32, B2, B3 and the prep 16 a step
     (int8: B4, B5 32, B7, B8 16); save_checkpoint (DCP) of every stage's
     params and AdamW state after step 1, restored into fresh params and a
     fresh optimizer, whose step 2 must be within 1e-6 of the uninterrupted
     one (bit-equality printed); hosts_alive over the ranks, device_heartbeat
     and a Watchdog on card 0, and a StepGuard that flags a step whose
     torch.cuda._sleep crosses its factor while the call returns at once,
     and no normal step.
 30. head dim 128 (run before phase 27): B1 bf16, fast B2/B3 and B13 at d=128
     against their plain versions at their phase-3, 6, 4 and 23 tolerances
     (HEAD128_CASES: t and s off a multiple of 128, causal t < s and t > s,
     rep 3, 5 and 128, GQA rep 4, one token, many key tiles; B1 on f32, bf16
     and [b, t, h, d] views, the K/V prep byte-equal to .to(bfloat16); the
     backward's prep byte-equal to the plain prep and its strided call equal
     to the contiguous one; B13 with non-finite stale scales at 16/16 and
     16/4 heads and its verify staircase at spec 2 and 5, each row bit-equal
     to its spec = 1 launch; every kernel twice for the same bits); BASELINE
     config 2 at (4, 16, 2048, 128) causal against the fp32 oracle by the
     JAX package's criteria (O mismatch rate <= 5e-5, dq/dk/dv <= 1.2e-4 at
     atol 1e-2); at that shape B1 (its f32 call split into prep and kernel,
     and on bf16), B2 and B3 timed beside their bounds, plain versions and
     SDPA's fused bf16 forward and backward, the whole fast backward call on
     the model's views with its prep, B2 + B3 at GQA rep 4, and B13 at 8
     slots x 16 q / 4 kv heads, length 304 of 1280 and at capacity; then
     make_train_step at TRAIN128_CFG (vocab 8192, d_model 2048, 16 heads x
     128, 4 layers, 4 x 2048 tokens, f32 params: phase 10's parity, 1 + 10
     steps, exactly 4 launches a step of B1, B2, B3 and the prep) and
     ServingEngine at SERVE128_CFG (16 q / 4 kv heads x 128, max_seq 1280,
     phase 5's traffic; f32 params: tokens equal `generate`'s; bf16:
     tokens/s; B1 4 launches, B13 as counted). The int8 family at d=128:
     B4 byte-equal on f32 and bf16 views at every grain; B4, B5, B7 and B8
     against their plain versions at phase 8's tolerances on
     HEAD128_INT8_CASES (t and s off a multiple of 128, causal t < s and t >
     s, GQA rep 4 and 8, rep 3, one token, a ragged length whose padded K
     rows set the last scale, more key tiles than stages, and the shapes the
     d=128 paths give the kernels: the int8 train step's, GQA rep 4 at
     2048, the serving prefill's) and with global offsets, each kernel
     twice for the same bits (B7's and B8's worst error printed with its
     case); B6 equal to B4 -> B5 and within phase
     12's tolerance of its plain version; B14 against its plain version and
     bit-equal to B13 at spec 1 and on the verify staircase; BASELINE
     config 4 at (4, 16, 2048, 128) (phase 9's criteria) and config 3 at
     (4, 16, {2048, 4096, 8192}, 128), GQA (4, 16q/4kv, 4096, 128) and K +
     8 non-causal at 2048 (phase 13's gate) against the fp32 oracle; B4,
     B5, B7, B8 timed at config 4's shape and GQA, B6 at config 3's, B4 +
     B5 at the serving prefill, B14 at the serving decode and capacity, each beside its
     plain version, bound and SDPA's d=128 calls; make_train_step at
     TRAIN128_CFG with attention="int8" (exactly 4 launches a step of B4,
     B5, B7, B8; the int8/bf16 gradient-norm ratio under GRAD_NORM_RATIO at
     every step) and ServingEngine at SERVE128_CFG with int8 prefill (B4 +
     B5, 4 launches each) on the slotted (B13) and paged (B14) caches, f32
     params' tokens equal `generate`'s, bf16 params' tokens/s. The int4
     decode kernels and the rCM step's kernels at d=128: B15 and B16 against
     their plain versions (phase 21's lengths: one token, off the 256-token
     chunk and the 128-row pack half, full capacity; shuffled and junk
     pages, non-finite stale scales; GQA rep 1 and 4), B16 bit-equal to B15,
     the verify staircase at spec 2 and 5 (rows bit-equal to spec = 1); B1
     fp32 and B9, B11 and B12 fast at HEAD128_JVP_CASES (t and s off 64 and
     32, causal and not, one token, the DiT's (4, 4, 4096, 128)) on the
     DiT's strided views, twice for the same bits, their preps byte-equal
     (phase 17's checks), and B1 fp32 at its tile edges under GQA; all six
     timed (the JVP family at (4, 4, 4096, 128) beside their plain versions,
     bounds and, for B1 fp32, SDPA f32; B15/B16 at SERVE128_CFG's decode
     shape and at capacity); ServingEngine(kv_quant="int4") at SERVE128_CFG
     on the slotted and paged caches (B1 4 launches, then only B15 or B16;
     paged tokens == slotted tokens; tokens/s); make_dit_rcm_step(fast=True)
     at DIT128_CFG (d_model 512, 4 heads x 128, 2 layers, seq 4096, batch 4:
     phase 20's card-vs-CPU parity at seq 512 in both modes and central
     differences, torch.func.jvp(dit_forward) through B10 once a layer, 1 +
     5 steps with losses falling and exactly 2 launches a step of B1 fp32,
     B9, B11, B12 and their preps; median step and max_memory_allocated).
     The exact modes at d=128: B10 (both modes) and B9, B11, B12 exact at
     HEAD128_JVP_CASES (each bit-equal on a second call), B10 exact at the
     dit_jvp shape (2, 4, 512, 128) with its keys split and its prep
     byte-equal, B2/B3 exact at phase 6's tile and edge cases (bit-equal on
     a second call) and timed at (4, 16, 2048, 128) beside SDPA's f32
     backward, the exact modes timed at (4, 4, 4096, 128), BASELINE config
     5's gate at (1, 2, 4096, 128) (phase 18 at 128), torch.func.jvp(
     dit_forward) at full size (median of 5, launches exactly B1 fp32, its
     prep and B10 once a layer a call) and make_dit_rcm_step(fast=False)
     for 1 + 3 steps (losses finite, launches a step exactly B1 fp32, its
     prep, B9, B11 and B12 exact once a layer; median step and
     max_memory_allocated).
 31. options (run after phase 30): B1's correction="beta" and "none" against
     their plain versions (O and lse, twice for the same bits) at the train
     shapes (4, 16, 2048, 64/128) causal on f32 and bf16 inputs, GQA (2,
     16q/4kv, 2048, 64/128), t and s off a multiple of 128, s within one
     key group, over three and four groups (an odd group of key tiles), on
     keys duplicated so that "beta" fires (its share of rows printed; a
     second call with tol = -inf says where), with offsets, and at JAX's
     extreme tied logits (O = 0, lse ~200 above eps's); the fp32 mode's
     rules at (4, 4, 4096, 64), GQA and causal edges;
     flash_attention_bf16(correction="beta"/"none") forward and backward at
     the train shape and flash_attention_fwd_fp32(correction=) at the DiT's
     as paths (counts from 0) against the plain forward and backward; both
     rules timed against "eps" beside SDPA and the bound; B18 at groups 8,
     32, 48 and 96 against its plain version at decode (m = 8) and prefill
     (m = 2048) rows of 1024 x 4096 and 4096 x 1024, each timed beside
     groups 64 and 128 (the bound counts the scale bytes); the bench LM with
     quantize_lm_weights(bits=4, group=32, include_embed=False): a prefill
     and 4 decode steps through `generate` (B18 must launch) and its logits
     against the plain path on the CPU. Phase 2 also holds B18's geometry at
     those groups and fails on a spill or C75xx note in its ANY instances.
`python3 chip_smoke.py options` runs phases 1, 2 and 31 alone.
`python3 chip_smoke.py sp_model` (four cards, NCCL; refused on fewer) runs
phases 1 and 2, then measures parallel/scaling_model.py's constants:
`nvidia-smi topo -m` and `nvlink --status` (printed, whatever they exit
with) and peer access; the kernels' rates at (4, 16, 4096, 64) causal by
utils/profiling.py (bf16: B1; prep + B2 + B3; int8: B4 + B5; B7 + B8); the
port's hop, all_gather, psum_scatter and all_to_all at a K/V shard pair and
at 1 KB (models/sharded_jobs.py:link_bench); the steady step of each
strategy at TRAIN_CFG on (1, 1, 4), max_seq 2048 and 8192, bf16 and int8 (2
warm-up and 5 timed steps, CUDA events on rank 0, one torch.profiler step
on the last rank: attention and NCCL kernels' device time and their
overlap); then the model under those constants beside the card.
Then one JSON line with per-kernel launches, errors, times and bounds, and,
last, {"ok": true, "device": {...}}. Weights and inputs are random from fixed
seeds. Kernel times are device times per call (wrapper included: casts and
allocation), from CUDA events around CUDA-graph replays (SDPA's backward
too); the port's forward + backward calls are CUDA events around eager
calls queued behind a device sleep (queued_ms: the host has queued the last
call before the card starts the first, else "not measured"); serving and
train step times are CUDA events or host wall clock around synchronised
work. They are records, not claims.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from quantizedattention_tpu_torch import _build
from quantizedattention_tpu_torch.models import (
    DiTConfig,
    TransformerConfig,
    dit_forward,
    dit_jvp_step,
    dit_param_leaves,
    init_dit,
    make_dit_rcm_step,
    rcm_loss,
    generate,
    init_transformer,
    lm_loss,
    make_train_step,
    param_leaves,
    transformer_forward,
)
from quantizedattention_tpu_torch.ops import (
    attention_jvp,
    attention_jvp_fwd,
    attention_jvp_fwd_plain,
    attention_tangent_fwd,
    attention_tangent_fwd_plain,
    attention_value_and_jvp,
    jvp_bwd_dkv,
    jvp_bwd_dkv_plain,
    jvp_bwd_dq,
    jvp_bwd_dq_plain,
    jvp_bwd_operands,
    jvp_bwd_prep,
    jvp_bwd_prep_plain,
    jvp_fwd_prep,
    jvp_fwd_prep_plain,
    bwd_operands,
    bwd_prep,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_bf16,
    int4_weight_matmul,
    int4_weight_matmul_plain,
    int8_attention_fwd_fused,
    int8_attention_fwd_fused_plain,
    int8_weight_matmul,
    int8_weight_matmul_plain,
    sage_attention_int8_inference,
    flash_bwd_dkv,
    flash_bwd_dkv_plain,
    flash_bwd_dq,
    flash_bwd_dq_plain,
    int8_attention_fwd,
    int8_attention_fwd_from_quantized,
    int8_attention_fwd_from_quantized_plain,
    int8_bwd_dkv,
    int8_bwd_dkv_plain,
    int8_bwd_dq,
    int8_bwd_dq_plain,
    int8_bwd_operands,
    quantize_qkv,
    quantize_qkv_plain,
    sage_attention_int8,
)
from quantizedattention_tpu_torch.ops.int8_fwd import _attend, _fused_launch_args
from quantizedattention_tpu_torch.ops.linear_tiling import STREAM_MAX_M, plan_int4, plan_int8
from quantizedattention_tpu_torch.ops.flash_fwd import (
    flash_attention_fwd,
    flash_attention_fwd_fp32,
    flash_attention_fwd_plain,
    kv_split_tf32,
    kv_split_tf32_plain,
    kv_to_bf16,
)
from quantizedattention_tpu_torch.ops import flash_tiling, int8_tiling, jvp_tiling
from quantizedattention_tpu_torch.ops.common import LOG2_E
from quantizedattention_tpu_torch.ops.int8_fwd import _qkv_jobs
from quantizedattention_tpu_torch.ops.jvp_tangent import tangent_prep, tangent_prep_plain
from quantizedattention_tpu_torch.models.transformer import (
    Sampling,
    _decode_logits,
    _filter_logits,
    _verify_logits,
    prefill_chunk_logits,
    prefill_slots,
)
from quantizedattention_tpu_torch.parallel import decode_tiling
from quantizedattention_tpu_torch.parallel.kv4_cache import (
    PACK,
    Int4KVCache,
    _pack_halves,
    decode_attention_int4,
    decode_attention_int4_plain,
    init_kv4_cache,
    unpack_tokens,
    verify_decode_attention_int4,
    verify_decode_attention_int4_plain,
)
from quantizedattention_tpu_torch.parallel.kv_cache import (
    QuantizedKVCache,
    decode_attention,
    decode_attention_plain,
    init_kv_cache,
    verify_decode_attention,
    verify_decode_attention_plain,
)
from quantizedattention_tpu_torch.parallel.paged4_cache import (
    Paged4KVCache,
    init_paged4_cache,
    paged4_decode_attention,
    paged4_decode_attention_plain,
    paged4_verify_attention,
    paged4_verify_attention_plain,
)
from quantizedattention_tpu_torch.parallel.paged_cache import (
    PagedKVCache,
    assign_pages,
    init_paged_cache,
    paged_decode_attention,
    paged_decode_attention_plain,
    paged_verify_attention,
    paged_verify_attention_plain,
)
from quantizedattention_tpu_torch.parallel.ring import _merge_partials
from quantizedattention_tpu_torch.quantize.int8 import (QuantJob, quant_int8, quant_int8_plain,
                                                        quant_int8_uncounted)
from quantizedattention_tpu_torch.quantize.weights import (
    QuantizedWeight,
    QuantizedWeight4,
    mm,
    quantize_lm_weights,
    quantize_weight,
    quantize_weight_int4,
)
from quantizedattention_tpu_torch.reference import (
    reference_attention,
    reference_attention_jvp,
    reference_attention_vjp,
)
from quantizedattention_tpu_torch.serve import ServingEngine
from quantizedattention_tpu_torch.utils import StepGuard, Watchdog, device_heartbeat, hosts_alive
from quantizedattention_tpu_torch.utils.testing import ATOL, GRAD_MISMATCH_RATE, mismatch_report

# kernel vs plain, unit-normal inputs: only the summation order and where P
# is rounded to bf16 differ. The kernel rounds each 128-key tile's P against
# the running max, the plain version against the row's final max, so an
# entry can differ by up to one bf16 ulp (2^-7 relative); in a row dominated
# by a few keys that moves l, and lse = m + log2(l) by up to log2(1 + 2^-7)
# = 1.1e-2 in the worst case.
FLASH_O_TOL, FLASH_LSE_TOL = 5e-3, 5e-3
DECODE_TOL = 5e-3
# bf16 model on the card vs the same bf16 model through the plain path on
# the CPU: relative L2 distance of the prefill logits
LOGITS_REL_TOL = 5e-2
# Backward kernel vs plain, as max|diff| / max|plain| per tensor, with O and
# lse from the same B1 run handed to both. Fast: both round the same
# operands at the same points, so only the f32 summation order differs, and
# it can tip a P or dS entry across a bf16 rounding boundary (one ulp, 2^-8
# relative, of one term of a sum over up to s terms): a few 1e-3 at most.
# Exact: fp32 throughout, only the summation order: ~1e-6.
BWD_FAST_TOL, BWD_EXACT_TOL = 1e-2, 1e-4
# Int8 backward kernels (B7, B8) vs plain, the same measure: both take the
# same int8 payloads, scales, O and lse and round P, dO and dS to bf16 at the
# same points, so only the f32 summation order differs (1.1e-4 at most on an
# H100 at the training shape). 1e-3 is the CPU tests' BWD_REL.
INT8_BWD_TOL = 1e-3
# lm_loss on the card vs the CPU plain path, same f32 params: the two differ
# where B1 rounds P (per 128-key tile on the card, per row on the CPU; a few
# 1e-3 in O, as the flash_fwd phase shows) and in summation order. Loss and
# gradients are smooth in O, so they move by the same order; the loss
# averages it away.
TRAIN_LOSS_REL, TRAIN_GRAD_REL_L2 = 1e-3, 5e-2
# The int8 path against the fp32 oracle: the JAX package's own criteria
# (tests/test_int8_attention.py): forward mismatch rate <= 2e-3 at atol 5e-2
# (also for tiny-magnitude causal inputs, whose dequant scale is ~1e-9), and
# gradients within relative L2 0.06.
INT8_ATOL, INT8_FWD_RATE, INT8_GRAD_REL_L2 = 5e-2, 2e-3, 0.06
# BASELINE config 4: the int8 run's global gradient norm stays below twice
# the bf16 run's at every step (tests/test_baseline_configs.py:96-98).
GRAD_NORM_RATIO = 2.0
# B6 against B4 then B5 on the same inputs: the same payloads and scales and
# B5's tile order, so lse must be equal and O within the JAX package's
# fused-vs-materialized criterion (tests/test_int8_attention.py:95-108).
FUSED_O_TOL = 1e-6
# B17/B18 against their plain versions: with an f32 output only the f32
# summation order differs (2e-4 of max|plain|, the JAX package's kernel test,
# tests/test_int8_weights.py:54); a bf16 output rounds that once more, so it
# may land one bf16 ulp away (on top of the f32 difference, which matters
# only for results near 0).
WEIGHT_F32_REL = 2e-4
# The JVP family (B1 fp32, B9-B12) against its plain versions, as
# max|diff| / max|plain| per tensor (lse: max|diff|), as B2/B3 are held.
# Where a tensor is 0 in exact arithmetic (one key: the softmax is constant,
# so dS = 0 and dK, dtK, dQ, dtQ vanish) both sides hold rounding noise, so
# it is held by max|diff| alone, against the unit-normal inputs' scale.
# Exact: fp32 throughout, only the summation order differs (3e-6 at 4096
# keys on an H100). B9 fast: the kernel rounds P to bf16 against the running max of each
# 32-key tile, the plain version against the row's final max, so an entry can
# differ by one bf16 ulp: compared as B1 bf16 is, 5e-3. B10-B12 fast: both
# round the same operands at the same points, so only the summation order
# differs, and it can tip an entry across a bf16 rounding boundary:
# BWD_FAST_TOL, as B2/B3.
JVP_EXACT_TOL, JVP_FWD_FAST_TOL = 1e-4, 5e-3
# BASELINE config 5's gate (tests/test_baseline_configs.py:101-116): 0
# mismatches at atol 1e-2 against the fp32 oracle; the JAX package's
# second-order gradient envelope (tests/test_jvp_grad.py), rtol and atol
# 5e-4; and its fast-vs-exact envelope, O 2e-2 and tO 5e-2.
CONFIG5_ATOL, JVP_GRAD_TOL, JVP_FAST_O, JVP_FAST_TO = 1e-2, 5e-4, 2e-2, 5e-2
# The rCM loss and gradients on the card vs the CPU plain path with the same
# params, both fast: the kernels' summation order against the plain
# versions' flips bf16 rounding of single products (1e-2 at most per kernel
# output, phase 17), and the loss and gradients are smooth in them.
DIT_GRAD_REL_L2 = 5e-2
# du/dt through torch.func.jvp of dit_forward (fp32 B1, exact B10) against
# the rCM pair path (fast B9): the same function, the pair path rounding each
# product's operands to bf16 (2^-8 relative), which the relative L2 distance
# averages over the output (1.0e-4 on an H100 at seq 512).
DIT_JVP_REL_L2 = 1e-2

# Published H100 SXM peaks (NVIDIA data sheet, dense, 700 W): a kernel's
# bound is the larger of its operations over the peak of their type and its
# bytes (each input read once, each output written once) over HBM bandwidth.
PEAK_BF16, PEAK_INT8, PEAK_FP32, HBM_BYTES_S = 989e12, 1979e12, 67e12, 3.35e12
PEAK_TF32 = 494.7e12

BENCH_CFG = TransformerConfig(vocab_size=8192, d_model=1024, n_heads=16, n_kv_heads=16,
                              head_dim=64, n_layers=4, max_seq=1280)
N_SLOTS, PROMPT_LEN, NEW_TOKENS, HORIZON = 8, 256, 96, 32
# phase 26's mesh: (data, model) and its ranks; one rank serves N_SLOTS /
# data slots with n_heads / model q and kv heads
MESH_SHAPE, MESH_RANKS = (2, 2), 4
MESH_ROWS, MESH_HEADS = N_SLOTS // MESH_SHAPE[0], BENCH_CFG.n_heads // MESH_SHAPE[1]
# training: BASELINE config 2's attention shape (4, 16, 2048, 64) in every layer
TRAIN_CFG = TransformerConfig(vocab_size=8192, d_model=1024, n_heads=16, n_kv_heads=16,
                              head_dim=64, n_layers=4, max_seq=2048)
TRAIN_BATCH, TRAIN_STEPS, PARITY_LEN = 4, 10, 256
GQA_CFG = TransformerConfig(vocab_size=512, d_model=256, n_heads=4, n_kv_heads=2,
                            head_dim=64, n_layers=2, max_seq=512)
GQA_BATCH = 8
# BASELINE config 5: the DiT's own defaults at seq 4096 (models/dit.py:43-50),
# batch 4; its attention shape is (4, 4, 4096, 64), non-causal
DIT_CFG = DiTConfig(seq_len=4096)
DIT_BATCH, DIT_STEPS, DIT_PARITY_LEN = 4, 5, 512
JVP_BENCH_SHAPE = (4, 16, 4096)  # bench.py:bench_jvp's (b, h, t), head_dim 64


def log(msg: str) -> None:
    print(msg, flush=True)


def device_ms(fn, calls: int = 20, replays: int = 10) -> float:
    """Mean device time of one `fn()` call in ms.

    `calls` calls are captured in one CUDA graph and the graph is replayed
    `replays` times between two CUDA events, so the span holds no host
    dispatch: at these sizes an eager loop of small launches measures the
    host's Python, not the card.
    """
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture (lazy library and allocator set-up)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def nbytes(*tensors) -> int:
    return sum(x.numel() * x.element_size() for x in tensors)


def visible_pairs(t: int, s: int, causal: bool, q_offset: int = 0, k_offset: int = 0) -> int:
    """(query, key) pairs attention computes: causal keeps k <= q on global
    positions, key j + k_offset <= query i + q_offset (row i sees min(s,
    max(0, i + q_offset - k_offset + 1)) keys)."""
    if not causal:
        return t * s
    d = q_offset - k_offset
    n = max(0, min(t, s - d))  # rows i < n (i + d + 1 <= s) see i + d + 1 keys, if positive
    lo = max(0, min(n, -d))  # rows below -d see none
    full = (n * (n + 1) - lo * (lo + 1)) // 2 + (n - lo) * d
    return full + (t - n) * s if t > n else full


def _strided(*xs):
    """[b, h, t, d] views of [b, t, h, d] storage with the same values, as the
    model hands q, k, v and dO in."""
    return [x.transpose(1, 2).contiguous().transpose(1, 2) for x in xs]


def bound(n_bytes: float, *work: tuple[float, float]) -> dict:
    """The least time for `n_bytes` of traffic and the operations of `work`,
    given as (operations, peak rate of their type) pairs whose times add."""
    t_ops, t_bytes = sum(ops / peak for ops, peak in work), n_bytes / HBM_BYTES_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(smi)
    log(f"[device] {smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.device_count()} visible, using {name}")
    return name, smi


def phase_build() -> None:
    secs = _build.build_all()
    log(f"[build] kernels + scheduler built/loaded in {secs:.1f} s")
    flash_bwd_lib = _build.load_kernel("flash_bwd")
    head_dims = [(f"{name} d={d}", getattr(lib, entry)(d), want(d))
                 for d in flash_tiling.HEAD_DIMS for name, lib, entry, want in (
                     ("flash_fwd", _build.load_kernel("flash_fwd"), "qa_flash_fwd_smem_bytes",
                      flash_tiling.shared_bytes),
                     ("flash_bwd dK/dV", flash_bwd_lib, "qa_flash_bwd_dkv_smem_bytes",
                      flash_tiling.dkv_shared_bytes),
                     ("flash_bwd dQ", flash_bwd_lib, "qa_flash_bwd_dq_smem_bytes",
                      flash_tiling.dq_shared_bytes))]
    head_dims += [(f"cache_decode {payload} d={d}",
                   _build.load_kernel("cache_decode").qa_decode_smem_bytes(bits, d),
                   decode_tiling.shared_bytes(payload, d))
                  for payload, bits, dims in (("int8", 8, decode_tiling.HEAD_DIMS_INT8),
                                              ("int4", 4, decode_tiling.HEAD_DIMS_INT4))
                  for d in dims]
    head_dims += [(f"flash_fwd fp32 d={d}",
                   _build.load_kernel("flash_fwd").qa_flash_fwd_f32_smem_bytes(d),
                   flash_tiling.fp32_shared_bytes(d)) for d in flash_tiling.FP32_HEAD_DIMS]
    head_dims += [(f"{name} d={d}", getattr(_build.load_kernel(lib), entry)(d), want(d))
                  for d in jvp_tiling.HEAD_DIMS for name, lib, entry, want in (
                      ("jvp dK/dV fast", "jvp", "qa_jvp_bwd_dkv_smem_bytes",
                       jvp_tiling.dkv_shared_bytes),
                      ("jvp dQ fast", "jvp", "qa_jvp_bwd_dq_smem_bytes",
                       jvp_tiling.dq_shared_bytes),
                      ("jvp fwd fast", "jvp", "qa_jvp_fwd_smem_bytes",
                       jvp_tiling.fwd_shared_bytes))]
    head_dims += [(f"{name} d={d}", getattr(_build.load_kernel(lib), entry)(d), want(d))
                  for d in int8_tiling.HEAD_DIMS for name, lib, entry, want in (
                      ("quant_int8", "quant_int8", "qa_quant_int8_smem_bytes",
                       int8_tiling.quant_shared_bytes),
                      ("int8_fwd", "int8_fwd", "qa_int8_fwd_smem_bytes", int8_tiling.shared_bytes),
                      ("int8_bwd dK/dV", "int8_bwd", "qa_int8_bwd_dkv_smem_bytes",
                       int8_tiling.dkv_shared_bytes),
                      ("int8_bwd dQ", "int8_bwd", "qa_int8_bwd_dq_smem_bytes",
                       int8_tiling.dq_shared_bytes))]
    # B10 in both modes, the exact modes' FFMA kernels and B2/B3 exact
    jvp_lib = _build.load_kernel("jvp")
    head_dims += [(f"jvp tangent {mode} d={d}", getattr(jvp_lib, entry)(d), want(d))
                  for d in jvp_tiling.HEAD_DIMS for mode, entry, want in (
                      ("exact", "qa_jvp_tangent_smem_bytes", jvp_tiling.tangent_shared_bytes),
                      ("fast", "qa_jvp_tangent_fast_smem_bytes",
                       jvp_tiling.tangent_fast_shared_bytes))]
    head_dims += [(f"jvp {kernel} exact d={d}", jvp_lib.qa_jvp_exact_smem_bytes(i, d),
                   jvp_tiling.exact_shared_bytes(kernel, d))
                  for d in jvp_tiling.HEAD_DIMS for i, kernel in enumerate(("fwd", "dkv", "dq"))]
    head_dims += [(f"flash_bwd {kernel} exact d={d}",
                   flash_bwd_lib.qa_flash_bwd_exact_smem_bytes(i, d),
                   flash_tiling.bwd_exact_shared_bytes(kernel, d))
                  for d in flash_tiling.HEAD_DIMS for i, kernel in enumerate(("dkv", "dq"))]
    for name, got, want in head_dims:
        if got != want:
            raise AssertionError(f"{name} asks for {got} shared bytes a block, its launch "
                                 f"geometry (ops/flash_tiling.py, ops/int8_tiling.py, "
                                 f"ops/jvp_tiling.py, parallel/decode_tiling.py) says {want}")
    geometry = [ctypes.c_int() for _ in range(3)]  # B4: cluster, threads, largest grain
    _build.load_kernel("quant_int8").qa_quant_int8_geometry(*map(ctypes.byref, geometry))
    want = (int8_tiling.QUANT_CLUSTER, int8_tiling.QUANT_THREADS, int8_tiling.QUANT_MAX_GRAIN)
    if tuple(g.value for g in geometry) != want:
        raise AssertionError(f"quant_int8.cu's cluster, threads and largest grain "
                             f"{[g.value for g in geometry]} differ from ops/int8_tiling.py's {want}")
    for m, k, n in WEIGHT_SHAPES + [WEIGHT_ODD]:  # B17/B18: every launch phases 15 and 31 make
        # quantize_weight_int4's packed rows at group 128 and at phase 31's groups
        plans = [(f"int4_linear group {g}", plan_int4(m, -(-k // (2 * g)) * g, n, g))
                 for g in (128,) + ANY_GROUPS]
        for name, plan in [("int8_linear", plan_int8(m, k, n))] + plans:
            lib = name.split()[0]
            smem = getattr(_build.load_kernel(lib), f"qa_{lib}_smem_bytes")(m, plan.bn)
            if smem != plan.shared_bytes:
                raise AssertionError(f"{name}.cu asks for {smem} shared bytes a block at m={m} "
                                     f"bn={plan.bn}, ops/linear_tiling.py says "
                                     f"{plan.shared_bytes}")
    for name in _build.KERNELS:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "(C75" in line:
                log(f"[build] {name}: {line.strip()}")
    # the flash forward (both modes) and backward (both modes), B5, B7 and
    # B8, B9, B11 and B12 fast (every head dim's instance), B10 exact (both
    # head dims) and the d=128 instances of B10 fast and of B9, B11 and B12
    # exact keep every wgmma asynchronous (no C75xx note) and spill nothing;
    # the decode kernel's instances (two blocks an SM at head dim 64: at most
    # 128 registers; one at 128, both payloads) and B4 spill nothing
    for name, only in (("flash_fwd", None), ("flash_bwd", None), ("int8_fwd", None),
                       ("int8_bwd", None),
                       ("jvp", ("jvp_fwd_wgmma", "jvp_fwd_prep_kernel", "jvp_dkv_wgmma",
                                "jvp_dq_wgmma", "jvp_bwd_prep_kernel", "jvp_tangent_tf32",
                                "tangent_prep_kernel", "tangent_merge_kernel",
                                "jvp_tangent_mmaILi128E", "jvp_fwd_kernelILi128E",
                                "jvp_dkv_kernelILi128E", "jvp_dq_kernelILi128E")),
                       ("cache_decode", ("decode_kernel",)), ("quant_int8", None)):
        bad = _ptxas_faults(_build.build_log(name), only)
        if bad:
            raise AssertionError(f"{name}'s ptxas notes: {bad}")
    # B18's ANY instances (bool template argument true, "Lb1E"): no spill and
    # no C75xx note; its first instances keep int4_tc_kernel's known C7517 at
    # the epilogue stores
    bad = [line for line in _ptxas_faults(_build.build_log("int4_linear")) if "Lb1E" in line]
    if bad:
        raise AssertionError(f"int4_linear's ANY instances' ptxas notes: {bad}")


def _ptxas_faults(log_text: str, only=None) -> list:
    """The lines of a ptxas -v log that phase 2 fails on: a C75xx note
    (wgmma serialized or waited on) anywhere, and a spill in any function or,
    given `only`, in the functions whose mangled names hold one of `only`."""
    bad, function = [], ""
    for line in log_text.splitlines():
        if "Function properties for" in line or "Compiling entry function" in line:
            function = line
        if "serialized" in line or "(C75" in line:
            bad.append(line.strip())
        elif "spill" in line and not (" 0 bytes spill stores" in line
                                      and " 0 bytes spill loads" in line):
            if only is None or any(name in function for name in only):
                bad.append(f"{function.strip()}: {line.strip()}")
    return bad


FLASH_CASES = [  # (b, h, h_kv, t, s, causal)
    (2, 16, 16, 256, 256, True),
    (2, 16, 4, 1000, 1000, True),
    (1, 4, 2, 77, 201, False),
]


# the bf16 forward's tile edges (phase 3 only; phase 6 has the backward's,
# BWD_TILE_CASES): t and s off a multiple of 128, causal t < s and t > s,
# rep 3 (rows with no visible key in a causal tile: the block at position
# 126 sees keys 128-255 only from 128 on), rep 5, 8 and 128, one token, and
# more key tiles than the ring has stages, causal and not
FLASH_EDGE_CASES = [
    (1, 4, 4, 200, 330, True),
    (1, 4, 4, 330, 200, True),
    (1, 6, 2, 300, 300, True),
    (1, 10, 2, 77, 201, False),
    (1, 16, 2, 300, 300, True),
    (1, 128, 1, 40, 300, True),
    (1, 2, 2, 1, 1, True),
    (1, 3, 1, 1, 1, False),
    (1, 2, 2, 1280, 1280, False),
]


def _check_flash(q, k, v, causal, label) -> float:
    """B1 against its plain version on (q, k, v) as given; a second call must
    give the same bits. Returns max|dO|."""
    o, lse = flash_attention_fwd(q, k, v, causal=causal)
    o2, lse2 = flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
        raise AssertionError(f"flash_fwd gave other bits on a second call at {label}")
    o_p, lse_p = flash_attention_fwd_plain(q, k, v, causal=causal)
    err_o = (o - o_p).abs().max().item()
    err_l = (lse - lse_p).abs().max().item()
    log(f"[flash_fwd] {label}: max|dO|={err_o:.3e} (tol {FLASH_O_TOL}) max|dlse|={err_l:.3e} "
        f"(tol {FLASH_LSE_TOL})")
    if not (err_o <= FLASH_O_TOL and err_l <= FLASH_LSE_TOL):
        raise AssertionError("flash_fwd kernel disagrees with its plain version")
    return err_o


def phase_flash(dev, gen) -> dict:
    """B1 on f32 and on bf16 inputs at every case, each against its plain
    version and called twice; the f32 path (in-kernel Q prep, the K/V prep
    launch) equal bit for bit to the bf16 path on bf16-representable inputs;
    [b, t, h, d] storage read as [b, h, t, d] equal to contiguous inputs; the
    K/V prep byte-equal to .to(bfloat16). Then timing at the serving shape.
    The edge cases draw from their own generator, so the later phases see the
    inputs they saw before those cases were added."""
    worst = 0.0
    edge_gen = torch.Generator(device=dev).manual_seed(11)
    for case in FLASH_CASES + FLASH_EDGE_CASES:
        b, h, h_kv, t, s, causal = case
        label = f"b={b} h={h} h_kv={h_kv} t={t} s={s} causal={causal}"
        g = gen if case in FLASH_CASES else edge_gen
        qkv = [torch.randn((b, n, m, 64), generator=g, device=dev)
               for n, m in ((h, t), (h_kv, s), (h_kv, s))]
        bf = [x.to(torch.bfloat16) for x in qkv]
        worst = max(worst, _check_flash(*qkv, causal, f"{label}, f32 in"),
                    _check_flash(*bf, causal, f"{label}, bf16 in"))
        o, lse = flash_attention_fwd(*bf, causal=causal)
        o_f, lse_f = flash_attention_fwd(*(x.float() for x in bf), causal=causal)
        o_t, lse_t = flash_attention_fwd(*_strided(*bf), causal=causal)
        kb, vb = kv_to_bf16(*_strided(*qkv[1:]))
        torch.cuda.synchronize()
        if not (torch.equal(o, o_f) and torch.equal(lse, lse_f)):
            raise AssertionError(f"flash_fwd on f32 inputs that bf16 represents differs from "
                                 f"the bf16 call at {label}")
        if not (torch.equal(o, o_t) and torch.equal(lse, lse_t)):
            raise AssertionError(f"flash_fwd on [b, t, h, d] views differs from contiguous "
                                 f"inputs at {label}")
        if not (torch.equal(kb, bf[1]) and torch.equal(vb, bf[2])):
            raise AssertionError(f"kv_to_bf16 differs from .to(bfloat16) at {label}")
    # time at the serving prefill's shape: 8 prompts x 256 tokens, 16 heads
    q, k, v = (torch.randn((N_SLOTS, 16, PROMPT_LEN, 64), generator=gen, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))
    ms = device_ms(lambda: flash_attention_fwd(q, k, v, causal=True))
    plain_ms = device_ms(lambda: flash_attention_fwd_plain(q, k, v, causal=True))
    lib_ms = device_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
    o, lse = flash_attention_fwd(q, k, v, causal=True)
    flops = 2 * 2 * N_SLOTS * 16 * visible_pairs(PROMPT_LEN, PROMPT_LEN, True) * 64
    bnd = bound(nbytes(q, k, v, o, lse), (flops, PEAK_BF16))
    log(f"[flash_fwd] (8,16,256,64) causal: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa {lib_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, **bnd, "library_ms": lib_ms,
            "library_call": "F.scaled_dot_product_attention(is_causal=True), bf16"}


def _decode_case(dev, gen, n_q, n_kv, lengths, stale, max_len=BENCH_CFG.max_seq, d=64):
    b = len(lengths)
    shape = (b, n_kv, max_len, d)
    k_i8 = torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
    v_i8 = torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
    sk = torch.rand(shape[:3], generator=gen, device=dev) * 0.028 + 0.002
    sv = torch.rand(shape[:3], generator=gen, device=dev) * 0.028 + 0.002
    length = torch.tensor(lengths, dtype=torch.int32, device=dev)
    if stale:
        dead = torch.arange(max_len, device=dev)[None, None, :] >= length.long()[:, None, None]
        sk = torch.where(dead, torch.nan, sk)
        sv = torch.where(dead, torch.inf, sv)
    q = torch.randn((b, n_q, d), generator=gen, device=dev)
    return q, QuantizedKVCache(k_i8, sk, v_i8, sv, length)


def phase_decode(dev, gen) -> dict:
    lengths = [0, 1, 127, 128, 1000, 1280, 300, 640]
    worst = 0.0
    for n_q, n_kv in ((16, 16), (16, 4)):
        q, cache = _decode_case(dev, gen, n_q, n_kv, lengths, stale=True)
        o, lse = decode_attention(q, cache, return_lse=True)
        torch.cuda.synchronize()
        o_p, lse_p = decode_attention_plain(q, cache, return_lse=True)
        live = cache.length > 0
        err_o = (o - o_p).abs().max().item()
        err_l = (lse[live] - lse_p[live]).abs().max().item()
        empty_ok = bool((o[~live] == 0).all() and torch.isneginf(lse[~live]).all())
        log(f"[decode] 8 slots, {n_q} q / {n_kv} kv heads, max_len {BENCH_CFG.max_seq}, "
            f"lengths {lengths}, non-finite stale scales: finite={bool(torch.isfinite(o).all())} "
            f"max|dO|={err_o:.3e} max|dlse|={err_l:.3e} (tol {DECODE_TOL}) empty_rows_ok={empty_ok}")
        if not (torch.isfinite(o).all() and err_o <= DECODE_TOL and err_l <= DECODE_TOL
                and empty_ok):
            raise AssertionError("decode kernel disagrees with its plain version")
        worst = max(worst, err_o)
    # time at the serving decode's shape: 8 slots x 16 heads, mid-generation
    length = PROMPT_LEN + NEW_TOKENS // 2
    q, cache = _decode_case(dev, gen, 16, 16, [length] * N_SLOTS, stale=False)
    ms = device_ms(lambda: decode_attention(q, cache))
    plain_ms = device_ms(lambda: decode_attention_plain(q, cache))
    o = decode_attention(q, cache)
    # the data needs each slot's K/V payloads and scales below its length only
    live_tokens = int(cache.length.sum()) * cache.k_i8.shape[1]
    kv_bytes = live_tokens * 2 * (64 * cache.k_i8.element_size() + cache.sk.element_size())
    flops = 2 * 2 * int(cache.length.sum()) * q.shape[1] * 64
    bnd = bound(kv_bytes + nbytes(q, o, cache.length), (flops, PEAK_BF16))
    log(f"[decode] 8 slots x 16 heads, length {length} of {BENCH_CFG.max_seq}: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
    out = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, **bnd, "library_ms": None}
    out.update(_capacity_times("decode", dev, lambda g, n_kv: _decode_case(
        dev, g, 16, n_kv, [BENCH_CFG.max_seq] * N_SLOTS, stale=False)))
    return out


def _capacity_times(name, dev, case) -> dict:
    """Kernel `name` at capacity (every row 1280 of 1280 tokens), 16/16 and
    16/4 heads, on `case(generator, n_kv)`'s (q, cache) from a generator of
    its own (the phases after draw what they drew before), beside its bound:
    the live tokens' payloads and scales, the table's entries, q, O and the
    lengths."""
    fn = VERIFY[name][3]
    gen = torch.Generator(device=dev).manual_seed(21)
    n_tok = BENCH_CFG.max_seq * N_SLOTS
    out = {}
    for n_kv in (16, 4):
        q, cache = case(gen, n_kv)
        ms = device_ms(lambda: fn(q, cache))
        o = fn(q, cache)
        d = q.shape[-1]
        # 2 x (payload + scale): int4 packs two tokens a byte
        per_tok = 2 * (d // 2 + 4) if name in ("decode4", "paged4_decode") else 2 * (d + 4)
        table = 4 * N_SLOTS * MAX_PAGES if name.startswith("paged") else 0
        bnd = bound(n_tok * n_kv * per_tok + table + nbytes(q, o, cache[-1]),
                    (2 * 2 * n_tok * q.shape[1] * d, PEAK_BF16))
        log(f"[{name}] 8 slots x 16 q / {n_kv} kv heads, length {BENCH_CFG.max_seq} of "
            f"{BENCH_CFG.max_seq}: kernel {ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
            f"({bnd['bound_by']}), {ms / bnd['bound_ms']:.2f}x")
        out[f"capacity_16q_{n_kv}kv_ms"] = ms
        out[f"capacity_16q_{n_kv}kv_bound_ms"] = bnd["bound_ms"]
    return out


def _serve(dev, smi, cfg, weight_quant=None, param_dtype=torch.bfloat16,
           **cache_kw) -> tuple[list, dict, float, dict]:
    """One full-width serving run of `cfg` (`param_dtype` params,
    `weight_quant`, the engine's cache options `cache_kw`): a warm-up run,
    every launch count set to 0, the timed run. It must give every request
    its budget of in-vocab tokens, repeat the warm-up's tokens, match
    `generate` on the engine's own
    params and the same 8 prompts (int8 KV caches only: `generate` decodes
    the slotted int8 cache), and keep prefill logits and one decode step's
    logits on the final cache state within LOGITS_REL_TOL of the plain path
    on the CPU. Returns (each request's tokens, the timed run's launches by
    kernel, its tokens/s, the engine's stats() with the requeues counted)."""
    params = init_transformer(cfg, torch.Generator(device=dev).manual_seed(0), dev, param_dtype)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=PROMPT_LEN).tolist() for _ in range(N_SLOTS)]
    eng = ServingEngine(params, cfg, dev, n_slots=N_SLOTS, scheduler="native",
                        param_dtype=param_dtype, decode_horizon=HORIZON,
                        weight_quant=weight_quant, **cache_kw)
    requeues = [0]
    requeue = eng.sched.requeue

    def counted_requeue(slot):
        requeues[0] += 1
        requeue(slot)

    eng.sched.requeue = counted_requeue
    label = f"attention={cfg.attention} weight_quant={weight_quant}" + "".join(
        f" {k}={v}" for k, v in cache_kw.items())
    if cfg.head_dim != BENCH_CFG.head_dim or param_dtype != torch.bfloat16:
        label += f" head_dim={cfg.head_dim} {cfg.n_heads}q/{cfg.n_kv_heads}kv " \
                 f"d_model={cfg.d_model} params={str(param_dtype)[6:]}"

    def serve():
        rids = [eng.submit(p, NEW_TOKENS) for p in prompts]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.run()
        torch.cuda.synchronize()
        return [out[r] for r in rids], time.perf_counter() - t0

    warm, _ = serve()
    _reset_counts()
    results, wall = serve()
    launches = _launch_counts()

    for r in results:
        if r.finish_reason != "length" or len(r.tokens) != NEW_TOKENS:
            raise AssertionError(f"request {r.request_id}: {r.finish_reason}, "
                                 f"{len(r.tokens)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.tokens):
            raise AssertionError(f"request {r.request_id}: token out of vocab")
    if [r.tokens for r in results] != [r.tokens for r in warm]:
        raise AssertionError(f"{label}: a second run gave different tokens")
    same = None
    if cache_kw.get("kv_quant") is None:
        want = generate(eng.params, torch.tensor(prompts, device=dev), cfg, NEW_TOKENS)
        want = want[:, PROMPT_LEN:].tolist()
        same = sum(r.tokens == w for r, w in zip(results, want))
        if same != N_SLOTS:
            raise AssertionError(f"{label}: engine tokens equal generate's for only "
                                 f"{same}/{N_SLOTS} requests")

    # the full model on the card vs the plain path on the CPU, same weights
    probe = torch.tensor([prompts[0][:64]], device=dev)
    with torch.no_grad():
        logits = transformer_forward(eng.params, probe, cfg).float().cpu()
        ref = transformer_forward(_to(eng.params, "cpu"), probe.cpu(), cfg).float()
    rel = ((logits - ref).norm() / ref.norm()).item()
    agree = (logits.argmax(-1) == ref.argmax(-1)).float().mean().item()
    log(f"[serve] {label}: prefill logits vs CPU plain path ({probe.shape[1]} tokens): rel L2 "
        f"{rel:.3e} (tol {LOGITS_REL_TOL}), argmax agreement {agree:.3f}")
    if not (torch.isfinite(logits).all() and rel <= LOGITS_REL_TOL):
        raise AssertionError(f"{label}: prefill logits disagree with the plain CPU path")
    dec_rel = _decode_parity(eng, label)

    n_tok = sum(len(r.tokens) for r in results)
    ttft_ms = statistics.median(r.ttft_s for r in results) * 1e3
    led = eng.ledger()
    stats = {**eng.stats(), "requeues": requeues[0], "decode_rel_l2": dec_rel}
    log(f"[serve] {label}: {N_SLOTS} requests x {NEW_TOKENS} tokens (prompt {PROMPT_LEN}, "
        f"horizon {HORIZON}) on {smi}: {n_tok / wall:.1f} tokens/s, wall {wall:.3f} s, median "
        f"TTFT {ttft_ms:.2f} ms, launches { {k: v for k, v in launches.items() if v} }, "
        f"dispatches {led['dispatches']}, fetch_s {led['fetch_s']:.3f}, requeues "
        f"{requeues[0]}, pages_free {stats.get('pages_free')}; tokens == generate for "
        f"{same}/{N_SLOTS}; repeat run identical")
    return [r.tokens for r in results], launches, n_tok / wall, stats


def _decode_parity(eng, label) -> float:
    """One decode step's logits from the engine's final cache state (every
    slot inactive, so nothing new is written) on the card against the plain
    path on a CPU copy of the same state; returns their relative L2."""
    cpu_caches = [type(c)(*(x.cpu() for x in c)) for c in eng.caches]
    card_caches = [type(c)(*(x.clone() for x in c)) for c in eng.caches]
    idle = torch.zeros_like(eng.active)
    with torch.no_grad():
        got, _ = _decode_logits(eng.params, card_caches, eng.last_tok, eng.pos, idle, eng.cfg)
        ref, _ = _decode_logits(_to(eng.params, "cpu"), cpu_caches, eng.last_tok.cpu(),
                                eng.pos.cpu(), idle.cpu(), eng.cfg)
    got, ref = got.float().cpu(), ref.float()
    rel = ((got - ref).norm() / ref.norm()).item()
    log(f"[serve] {label}: decode logits vs CPU plain path on the final cache state: rel L2 "
        f"{rel:.3e} (tol {LOGITS_REL_TOL})")
    if not (torch.isfinite(got).all() and rel <= LOGITS_REL_TOL):
        raise AssertionError(f"{label}: decode logits disagree with the plain CPU path")
    return rel


def phase_serving(dev, smi) -> tuple[list, dict]:
    """Phase 5: bf16 serving through B1 (prefill) and B13 (decode) only."""
    tokens, launches, _, _ = _serve(dev, smi, BENCH_CFG)
    used = {k for k, v in launches.items() if v}
    if used != {"flash_fwd", "decode"}:
        raise AssertionError(f"the served run launched {launches}, want flash_fwd and decode only")
    return tokens, launches


def phase_serving_quantized(dev, smi, bf16_tokens, bf16_launches) -> dict:
    """Phase 16: the bench LM served with int8 attention, then with int8 and
    int4 weights, between two bf16 runs of phase 5's (the engine is
    host-bound, so its speed drifts over a process's life: each quantized
    run is compared with bf16 runs made beside it). Returns each quantized
    run's launches of the kernels it ran, by path."""
    n_layers = BENCH_CFG.n_layers
    per_pass = 6 * n_layers + 1  # projections and the unembedding of one forward
    runs, speed = {}, {}
    for path, cfg, wq in (("bf16_before", BENCH_CFG, None),
                          ("serve_int8", dataclasses.replace(BENCH_CFG, attention="int8"), None),
                          ("serve_w8", BENCH_CFG, "int8"), ("serve_w4", BENCH_CFG, "int4"),
                          ("bf16_after", BENCH_CFG, None)):
        tokens, launches, speed[path], _ = _serve(dev, smi, cfg, wq)
        used = {k for k, v in launches.items() if v}
        if path.startswith("bf16"):
            if tokens != bf16_tokens or launches != bf16_launches:
                raise AssertionError(f"{path}: the bf16 run differs from phase 5's")
            continue
        if path == "serve_int8":
            # prefill through B4 + B5, n_layers launches per prefill dispatch
            ok = (used == {"quant_int8", "int8_fwd", "decode"}
                  and launches["quant_int8"] == launches["int8_fwd"]
                  and launches["int8_fwd"] % n_layers == 0)
        else:
            kernel = "int8_linear" if wq == "int8" else "int4_linear"
            passes = (launches["flash_fwd"] + launches["decode"]) // n_layers
            ok = (used == {"flash_fwd", "decode", kernel}
                  and launches[kernel] == passes * per_pass)
        if not ok:
            raise AssertionError(f"{path}: launches {launches}")
        flat = [t for toks in tokens for t in toks]
        ref = [t for toks in bf16_tokens for t in toks]
        share = sum(a == b for a, b in zip(flat, ref)) / len(ref)
        log(f"[serve] {path}: {share:.3f} of the tokens equal the bf16 run's")
        runs[path] = {k: v for k, v in launches.items() if v}
    if bf16_launches["decode"] != runs["serve_w8"]["decode"]:
        raise AssertionError("the quantized runs decoded another number of steps")
    bf16 = (speed["bf16_before"] + speed["bf16_after"]) / 2
    log("[serve] tokens/s against the mean of the bf16 runs beside them ("
        f"{speed['bf16_before']:.1f}, {speed['bf16_after']:.1f}): "
        + ", ".join(f"{path} {speed[path] / bf16:.3f}" for path in runs))
    return runs


# --------------------------------------------------------------------------
# Cache kinds: paged int8 (B14), slotted int4 (B15), paged int4 (B16)
# --------------------------------------------------------------------------

CACHE_LENGTHS = [0, 1, 127, 128, 1000, 1280, 300, 640]
PAGE = 128
MAX_PAGES = BENCH_CFG.max_seq // PAGE  # 10


def _page_table(lengths, n_pages, seed):
    """[n, MAX_PAGES] int32: row s owns ceil(len / PAGE) + 1 pages (at most
    MAX_PAGES, as an engine row owns prompt + budget), drawn from a shuffled
    pool without page 0; the rest of the row is 0, the garbage page."""
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(seed)) + 1
    table = torch.zeros((len(lengths), MAX_PAGES), dtype=torch.int32)
    for s, length in enumerate(lengths):
        owned = min(MAX_PAGES, -(-length // PAGE) + 1)
        table[s, :owned] = perm[s * MAX_PAGES: s * MAX_PAGES + owned]
    return table


def _to_pages(dense, scales, table, n_pages, gen):
    """Dense rows [n, h, MAX_PAGES * rows, d] and token scales [n, h,
    MAX_PAGES * PAGE] into a pool through `table`: the pages a row owns get
    its rows in order, every other page (page 0 included) junk payloads and
    NaN scales. Returns (payload pool [h, n_pages, rows, d], scales
    [n_pages, h, PAGE])."""
    n, h, total, d = dense.shape
    rows = total // MAX_PAGES
    pool = torch.randint(-128, 128, (h, n_pages, rows, d), generator=gen, device=dense.device,
                         dtype=torch.int8)
    pool_s = torch.full((n_pages, h, PAGE), torch.nan, device=dense.device)
    table = table.to(dense.device)
    owned = table > 0
    pool[:, table[owned].long()] = dense.reshape(n, h, MAX_PAGES, rows, d).transpose(0, 1)[:, owned]
    pool_s[table[owned].long()] = scales.reshape(n, h, MAX_PAGES, PAGE).transpose(1, 2)[owned]
    return pool, pool_s


def _paged8_case(dev, gen, n_q, n_kv, lengths, stale, d=64):
    """q, the slotted int8 cache of `_decode_case` and its paged twin through
    shuffled pages (junk pages; stale: NaN/inf scales), with the page table
    and the pool's pages."""
    q, dense8 = _decode_case(dev, gen, n_q, n_kv, lengths, stale, d=d)
    n_pages = 1 + len(lengths) * MAX_PAGES
    table = _page_table(lengths, n_pages, seed=len(lengths) + n_kv).to(dev)
    k_pages, sk_pages = _to_pages(dense8.k_i8, dense8.sk, table, n_pages, gen)
    v_pages, sv_pages = _to_pages(dense8.v_i8, dense8.sv, table, n_pages, gen)
    if stale:
        sv_pages = torch.where(torch.isnan(sv_pages), torch.inf, sv_pages)
    paged8 = PagedKVCache(k_pages, sk_pages, v_pages, sv_pages, table, dense8.length)
    return q, dense8, paged8, table, n_pages


def _cache_kinds(dev, gen, n_q, n_kv, lengths, stale, d=64):
    """The same attention problem in all four cache kinds at head dim d: q,
    the slotted int8 cache of `_decode_case`, its paged twin through shuffled
    pages, a slotted int4 cache of random nibbles (stale: NaN/inf scales past
    each length, in both halves of a half-live byte row) and its paged int4
    twin (the same token values repacked split-half per page)."""
    q, dense8, paged8, table, n_pages = _paged8_case(dev, gen, n_q, n_kv, lengths, stale, d=d)
    n, max_len = len(lengths), BENCH_CFG.max_seq
    length = dense8.length

    shape4 = (n, n_kv, max_len // 2, d)
    k4 = torch.randint(-128, 128, shape4, generator=gen, device=dev, dtype=torch.int8)
    v4 = torch.randint(-128, 128, shape4, generator=gen, device=dev, dtype=torch.int8)
    sk4 = torch.rand(shape4[:2] + (max_len,), generator=gen, device=dev) * 0.28 + 0.02
    sv4 = torch.rand(shape4[:2] + (max_len,), generator=gen, device=dev) * 0.28 + 0.02
    if stale:
        dead = torch.arange(max_len, device=dev)[None, None, :] >= length.long()[:, None, None]
        sk4 = torch.where(dead, torch.nan, sk4)
        sv4 = torch.where(dead, torch.inf, sv4)
    dense4 = Int4KVCache(k4, sk4, v4, sv4, length)

    def repack(p):  # pack-block order -> split-half per page of PAGE tokens
        nib = (unpack_tokens(p, PACK) & 0x0F).to(torch.int8)
        return _pack_halves(nib, PAGE)

    k4_pages, sk4_pages = _to_pages(repack(k4), sk4, table, n_pages, gen)
    v4_pages, sv4_pages = _to_pages(repack(v4), sv4, table, n_pages, gen)
    if stale:
        sv4_pages = torch.where(torch.isnan(sv4_pages), torch.inf, sv4_pages)
    paged4 = Paged4KVCache(k4_pages, sk4_pages, v4_pages, sv4_pages, table, length)
    return q, dense8, paged8, dense4, paged4


def _check_decode_kernel(name, fn, plain, q, cache, label) -> float:
    """A decode kernel against its plain version on the same inputs: O and
    lse within DECODE_TOL, O finite, empty rows O = 0 and lse = -inf."""
    o, lse = fn(q, cache, return_lse=True)
    torch.cuda.synchronize()
    o_p, lse_p = plain(q, cache, return_lse=True)
    live = cache[-1] > 0
    err_o = (o - o_p).abs().max().item()
    err_l = (lse[live] - lse_p[live]).abs().max().item()
    empty_ok = bool((o[~live] == 0).all() and torch.isneginf(lse[~live]).all())
    finite = bool(torch.isfinite(o).all())
    log(f"[{name}] {label}: finite={finite} max|dO|={err_o:.3e} max|dlse|={err_l:.3e} "
        f"(tol {DECODE_TOL}) empty_rows_ok={empty_ok}")
    if not (finite and err_o <= DECODE_TOL and err_l <= DECODE_TOL and empty_ok):
        raise AssertionError(f"{name} kernel disagrees with its plain version")
    return err_o


def _check_twins(name, got, want, label, exact=False) -> float:
    """Two kernels on the same K/V: (O, lse) within DECODE_TOL, or with
    `exact` bit for bit (B14 and B13, B16 and B15 put every token in the
    same slot of the same chunk and tile: only the addressing of a payload
    row differs)."""
    d_o = (got[0] - want[0]).abs().max().item()
    live = torch.isfinite(want[1])
    d_l = (got[1][live] - want[1][live]).abs().max().item()
    same_empty = bool(torch.equal(torch.isfinite(got[1]), live))
    equal = bool(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))
    log(f"[{name}] {label}: max|dO|={d_o:.3e} max|dlse|={d_l:.3e} (tol "
        f"{'0, bit for bit' if exact else DECODE_TOL}) same empty rows={same_empty} "
        f"bit-equal={equal}")
    if not (d_o <= DECODE_TOL and d_l <= DECODE_TOL and same_empty and (equal or not exact)):
        raise AssertionError(f"{name}: {label} disagree")
    return d_o


def phase_cache_kernels(dev, gen) -> dict:
    """Phase 21: B14, B15 and B16 against their plain versions at the bench
    widths (16/16 and 16/4 heads), with shuffled pages, junk pages and
    non-finite stale scales; B14 against B13 and B16 against B15 on the same
    K/V, bit for bit; then each timed at the serving decode shape beside B13
    and its plain version, and at capacity beside its bound."""
    kernels = {"paged_decode": (paged_decode_attention, paged_decode_attention_plain),
               "decode4": (decode_attention_int4, decode_attention_int4_plain),
               "paged4_decode": (paged4_decode_attention, paged4_decode_attention_plain)}
    err = dict.fromkeys(kernels, 0.0)
    twins = {}
    for n_q, n_kv in ((16, 16), (16, 4)):
        q, dense8, paged8, dense4, paged4 = _cache_kinds(dev, gen, n_q, n_kv, CACHE_LENGTHS, True)
        label = (f"8 seqs, {n_q} q / {n_kv} kv heads, page {PAGE} x {MAX_PAGES}, lengths "
                 f"{CACHE_LENGTHS}, shuffled pages, junk pages, non-finite stale scales")
        for name, cache in (("paged_decode", paged8), ("decode4", dense4),
                            ("paged4_decode", paged4)):
            err[name] = max(err[name], _check_decode_kernel(name, *kernels[name], q, cache, label))
        b13 = decode_attention(q, dense8, return_lse=True)
        b14 = paged_decode_attention(q, paged8, return_lse=True)
        twins[f"paged_decode_vs_decode_{n_kv}"] = _check_twins(
            "paged_decode", b14, b13, f"B14 on shuffled pages vs B13 dense, {n_q}/{n_kv} heads",
            exact=True)
        b15 = decode_attention_int4(q, dense4, return_lse=True)
        b16 = paged4_decode_attention(q, paged4, return_lse=True)
        twins[f"paged4_decode_vs_decode4_{n_kv}"] = _check_twins(
            "paged4_decode", b16, b15, f"B16 on shuffled pages vs B15 dense, {n_q}/{n_kv} heads",
            exact=True)

    # time at the serving decode's shape: 8 slots x 16 heads, mid-generation
    length = PROMPT_LEN + NEW_TOKENS // 2
    q, dense8, paged8, dense4, paged4 = _cache_kinds(dev, gen, 16, 16, [length] * N_SLOTS, False)
    n_tok = length * N_SLOTS
    live_pages = N_SLOTS * -(-length // PAGE)
    flops = 2 * 2 * n_tok * q.shape[1] * 64
    b13_ms = device_ms(lambda: decode_attention(q, dense8))
    out = {}
    for name, cache, per_tok, table_bytes in (
            ("paged_decode", paged8, 136, 4 * live_pages), ("decode4", dense4, 72, 0),
            ("paged4_decode", paged4, 72, 4 * live_pages)):
        fn, plain = kernels[name]
        ms = device_ms(lambda: fn(q, cache))
        plain_ms = device_ms(lambda: plain(q, cache), calls=4, replays=5)
        o = fn(q, cache)
        # the live tokens' K/V payloads and scales per kv head, the table
        # entries of the live pages, q, O and the lengths
        n_bytes = n_tok * cache[0].shape[0 if name != "decode4" else 1] * per_tok + table_bytes
        bnd = bound(n_bytes + nbytes(q, o, cache[-1]), (flops, PEAK_BF16))
        log(f"[{name}] 8 slots x 16 heads, length {length} of {BENCH_CFG.max_seq}: kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, B13 {b13_ms:.4f} ms, bound "
            f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
        out[name] = {"max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms, **bnd,
                     "library_ms": None, "decode_ms_beside": b13_ms}
    out["paged_decode"]["max_abs_diff_vs_decode"] = max(
        v for k, v in twins.items() if k.startswith("paged_decode_"))
    out["paged4_decode"]["max_abs_diff_vs_decode4"] = max(
        v for k, v in twins.items() if k.startswith("paged4_decode_"))

    # B14, B15 and B16 at capacity (1280 of 1280 tokens), 16/16 and 16/4 heads
    for name, at in (("paged_decode", 2), ("decode4", 3), ("paged4_decode", 4)):
        def case(g, n_kv, at=at):  # q and the kind's cache
            kinds = _cache_kinds(dev, g, 16, n_kv, [BENCH_CFG.max_seq] * N_SLOTS, False)
            return kinds[0], kinds[at]
        out[name].update(_capacity_times(name, dev, case))
    return out


CACHE_KERNELS = {"serve_paged": "paged_decode", "serve_kv4": "decode4",
                 "serve_paged4": "paged4_decode", "serve_paged_pressure": "paged_decode"}


def phase_serving_caches(dev, smi, bf16_tokens, bf16_launches) -> dict:
    """Phase 22: phase 5's run on the paged int8 pool, the slotted int4
    cache, the paged int4 pool, and the paged pool with 13 pages (four
    requests at a time: admission requeues and pages are recycled while
    banks are in flight), between two bf16 slotted runs. Paged tokens equal
    phase 5's, paged int4 tokens equal slotted int4's; each run launches B1
    and its cache's decode kernel only. Returns each run's launches."""
    n_need = -(-(PROMPT_LEN + NEW_TOKENS) // PAGE)
    pressure_pages = 1 + 4 * n_need
    runs, speed, tokens = {}, {}, {}
    for path, kw in (("bf16_before", {}), ("serve_paged", {"cache": "paged"}),
                     ("serve_kv4", {"kv_quant": "int4"}),
                     ("serve_paged4", {"cache": "paged", "kv_quant": "int4"}),
                     ("serve_paged_pressure", {"cache": "paged", "n_pages": pressure_pages}),
                     ("bf16_after", {})):
        tokens[path], launches, speed[path], stats = _serve(dev, smi, BENCH_CFG, **kw)
        used = {k for k, v in launches.items() if v}
        if path.startswith("bf16"):
            if tokens[path] != bf16_tokens or launches != bf16_launches:
                raise AssertionError(f"{path}: the bf16 run differs from phase 5's")
            continue
        if used != {"flash_fwd", CACHE_KERNELS[path]}:
            raise AssertionError(f"{path}: launches {launches}, want flash_fwd and "
                                 f"{CACHE_KERNELS[path]} only")
        same_steps = launches[CACHE_KERNELS[path]] == bf16_launches["decode"]
        if not same_steps and path != "serve_paged_pressure":
            raise AssertionError(f"{path} decoded another number of steps than phase 5")
        if path in ("serve_paged", "serve_paged_pressure") and tokens[path] != bf16_tokens:
            raise AssertionError(f"{path}: tokens differ from the slotted engine's")
        if path == "serve_paged4" and tokens[path] != tokens["serve_kv4"]:
            raise AssertionError("serve_paged4: tokens differ from the slotted int4 engine's")
        if path == "serve_paged_pressure" and not (
                stats["requeues"] > 0 and stats["pages_free"] == pressure_pages - 1):
            raise AssertionError(f"serve_paged_pressure: requeues {stats['requeues']}, "
                                 f"pages_free {stats['pages_free']}")
        flat = [t for toks in tokens[path] for t in toks]
        ref = [t for toks in bf16_tokens for t in toks]
        share = sum(a == b for a, b in zip(flat, ref)) / len(ref)
        log(f"[serve] {path}: {share:.3f} of the tokens equal the slotted int8 run's; "
            f"requeues {stats['requeues']}, pages_free {stats.get('pages_free')}")
        runs[path] = {k: v for k, v in launches.items() if v}
    bf16 = (speed["bf16_before"] + speed["bf16_after"]) / 2
    log("[serve] cache kinds, tokens/s against the mean of the bf16 slotted runs beside them ("
        f"{speed['bf16_before']:.1f}, {speed['bf16_after']:.1f}): "
        + ", ".join(f"{path} {speed[path]:.1f} ({speed[path] / bf16:.3f})" for path in runs))
    return runs


# --------------------------------------------------------------------------
# Speculative decoding: the verify staircase of B13-B16 and spec serving
# --------------------------------------------------------------------------

# rows shorter than spec (0, 1, 3), len % 128 below spec (129, 257, 640,
# and 1280, the full capacity), and a long row
SPEC_LENGTHS = [0, 1, 3, 129, 257, 1000, 1280, 640]
SPECS = (2, 5)
# kernel row -> (verify wrapper and its counter name, plain version, spec = 1 wrapper)
VERIFY = {
    "decode": (verify_decode_attention, "verify", verify_decode_attention_plain,
               decode_attention),
    "paged_decode": (paged_verify_attention, "paged_verify", paged_verify_attention_plain,
                     paged_decode_attention),
    "decode4": (verify_decode_attention_int4, "verify4", verify_decode_attention_int4_plain,
                decode_attention_int4),
    "paged4_decode": (paged4_verify_attention, "paged4_verify", paged4_verify_attention_plain,
                      paged4_decode_attention),
}


def _with_length(cache, length):
    return type(cache)(*cache[:-1], length)


def _check_verify(name, q, cache, label) -> float:
    """A verify kernel against its plain version (O within DECODE_TOL, finite,
    0 where a query sees no token), and each query row j bit-equal to the
    spec = 1 launch of the same kernel at length len - spec + 1 + j."""
    fn, _, plain, one = VERIFY[name]
    spec = q.shape[2]
    o = fn(q, cache)
    torch.cuda.synchronize()
    o_p = plain(q, cache)
    lim = cache[-1].long()[:, None] - spec + 1 + torch.arange(spec, device=q.device)  # [n, s]
    empty = (lim <= 0)[:, None, :].expand(-1, q.shape[1], -1)
    err = (o - o_p).abs().max().item()
    finite = bool(torch.isfinite(o).all())
    empty_ok = bool((o[empty] == 0).all())
    unequal = [j for j in range(spec) if not torch.equal(
        o[:, :, j], one(q[:, :, j], _with_length(cache, lim[:, j].clamp(min=0).int())))]
    log(f"[{name}] verify spec={spec}, {label}: finite={finite} max|dO|={err:.3e} (tol "
        f"{DECODE_TOL}) empty_rows_ok={empty_ok} rows bit-equal to spec=1 at their length: "
        f"{spec - len(unequal)}/{spec}")
    if not (finite and err <= DECODE_TOL and empty_ok and not unequal):
        raise AssertionError(f"{name}: the verify kernel disagrees (rows {unequal})")
    return err


def phase_verify_kernels(dev, gen) -> dict:
    """Phase 23: the verify staircase of B13-B16 against the plain versions
    and against their own spec = 1 launches, then timed at the spec serving
    shape beside the spec = 1 launch."""
    err = dict.fromkeys(VERIFY, 0.0)
    for n_q, n_kv in ((16, 16), (16, 4)):
        _, dense8, paged8, dense4, paged4 = _cache_kinds(dev, gen, n_q, n_kv, SPEC_LENGTHS, True)
        caches = {"decode": dense8, "paged_decode": paged8, "decode4": dense4,
                  "paged4_decode": paged4}
        for spec in SPECS:
            q = torch.randn((len(SPEC_LENGTHS), n_q, spec, 64), generator=gen, device=dev)
            label = (f"8 seqs, {n_q} q / {n_kv} kv heads, lengths {SPEC_LENGTHS}, shuffled "
                     f"pages, junk pages, non-finite stale scales")
            for name, cache in caches.items():
                err[name] = max(err[name], _check_verify(name, q, cache, label))

    spec, length = SPEC_K + 1, PROMPT_LEN + NEW_TOKENS // 2
    q1, dense8, paged8, dense4, paged4 = _cache_kinds(dev, gen, 16, 16, [length] * N_SLOTS,
                                                      False)
    q = torch.randn((N_SLOTS, 16, spec, 64), generator=gen, device=dev)
    live_pages = N_SLOTS * -(-length // PAGE)
    # each query row sees its own prefix: row j, length - spec + 1 + j tokens
    pairs = N_SLOTS * sum(length - spec + 1 + j for j in range(spec))
    flops = 2 * 2 * pairs * q.shape[1] * 64
    out = {}
    for name, cache, per_tok, table_bytes in (
            ("decode", dense8, 136, 0), ("paged_decode", paged8, 136, 4 * live_pages),
            ("decode4", dense4, 72, 0), ("paged4_decode", paged4, 72, 4 * live_pages)):
        fn, _, plain, one = VERIFY[name]
        ms = device_ms(lambda: fn(q, cache))
        one_ms = device_ms(lambda: one(q1, cache))
        plain_ms = device_ms(lambda: plain(q, cache), calls=4, replays=5)
        o = fn(q, cache)
        # the live tokens' K/V payloads and scales per kv head (16), the
        # table entries of the live pages, q, O and the lengths
        n_bytes = length * N_SLOTS * 16 * per_tok + table_bytes + nbytes(q, o, cache[-1])
        bnd = bound(n_bytes, (flops, PEAK_BF16))
        log(f"[{name}] verify 8 slots x 16 heads x spec {spec}, length {length} of "
            f"{BENCH_CFG.max_seq}: kernel {ms:.4f} ms, spec=1 {one_ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
        out[name] = {"verify_max_abs_err": err[name], "verify_ms": ms, "verify_plain_ms": plain_ms,
                     "verify_bound_ms": bnd["bound_ms"], "verify_bound_by": bnd["bound_by"],
                     "verify_spec1_ms": one_ms, "verify_shape": f"8 x 16 heads x spec {spec}, "
                                                               f"length {length}"}
    return out


# bench.py:bench_spec_decode: the bench LM at max_seq ceil((256 + 256) / 128)
# * 128 = 512, 8 periodic prompts of 256 tokens (16-token motifs), 96 new
# tokens, spec_decode=4 beside the plain engine at horizon 32
SPEC_CFG = dataclasses.replace(BENCH_CFG, max_seq=512)
SPEC_K = 4
# near-tie floor: a spec token that differs from the plain run's is a fault
# unless the plain run's top-2 logit gap there (in f32, before the bf16
# rounding of the logits) is below this, or below one bf16 ulp of its top
# logit: the engine argmaxes bf16 logits, which cannot resolve a smaller
# gap (one ulp is 0.0156 for logits in [2, 4)), and the verify pass rounds
# its bf16 projections at other points than the one-row decode pass
SPEC_TIE_GAP = 1e-2
SPEC_KINDS = {"": {}, "_paged": {"cache": "paged"}, "_kv4": {"kv_quant": "int4"},
              "_paged4": {"cache": "paged", "kv_quant": "int4"}}
DECODE_ROW = {"": "decode", "_paged": "paged_decode", "_kv4": "decode4",
              "_paged4": "paged4_decode"}


def _spec_prompts():
    return [(list(range(100 + 16 * i, 116 + 16 * i)) * (PROMPT_LEN // 16 + 1))[:PROMPT_LEN]
            for i in range(N_SLOTS)]


def _spec_serve(dev, params, prompts, label, **kw):
    """A warm-up run and a timed run of one engine (counts set to 0 between
    them); the timed run must repeat the warm-up's tokens, all in vocab and
    at the budget. Returns (engine, tokens, launches, wall seconds)."""
    eng = ServingEngine(params, SPEC_CFG, dev, n_slots=N_SLOTS, scheduler="native",
                        param_dtype=torch.bfloat16, **kw)

    def serve():
        rids = [eng.submit(p, NEW_TOKENS) for p in prompts]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.run()
        torch.cuda.synchronize()
        return [out[r].tokens for r in rids], time.perf_counter() - t0

    warm, _ = serve()
    _reset_counts()
    tokens, wall = serve()
    launches = _launch_counts()
    if tokens != warm:
        raise AssertionError(f"{label}: a second run gave different tokens")
    if not all(len(t) == NEW_TOKENS and all(0 <= x < SPEC_CFG.vocab_size for x in t)
               for t in tokens):
        raise AssertionError(f"{label}: a request's tokens are short or out of vocab")
    return eng, tokens, launches, wall


def _plain_gaps(params, prompts, plain, firsts, kv_quant, cfg=SPEC_CFG) -> dict:
    """The plain run's top-2 logit gaps where request i first chose
    plain[i][firsts[i]]: its computation replayed exactly, the 8 prompts
    prefilled in one batch into slotted rows of its payload type (a paged
    row computes the slotted row's logits bit for bit), then its tokens
    teacher-forced through the same batched decode steps its banks ran.
    The final hidden state comes out through an identity unembedding (exact
    in bf16), so the gap is read in f32 as well as in the bf16 logits the
    engine argmaxes; the replay's own argmax tokens are checked against the
    plain run's. Returns {i: (f32 gap, bf16 gap, top logit)}."""
    dev = params["unembed"].w_i8.device if isinstance(params["unembed"], QuantizedWeight) \
        else params["unembed"].device
    n = len(prompts)
    init = init_kv4_cache if kv_quant else init_kv_cache
    caches = [init(n, cfg.n_kv_heads, cfg.max_seq, cfg.head_dim, dev)
              for _ in range(cfg.n_layers)]
    lens = torch.tensor([len(p) for p in prompts], device=dev)
    slots = torch.arange(n, device=dev)
    hidden_params = dict(params, unembed=torch.eye(cfg.d_model, dtype=torch.bfloat16,
                                                   device=dev))
    unembed = params["unembed"]
    dense = unembed.dequantize() if isinstance(unembed, QuantizedWeight) else unembed.float()
    toks = torch.tensor(plain, device=dev)  # [n, NEW_TOKENS]
    on = torch.ones((n,), dtype=torch.bool, device=dev)
    out, preds = {}, []
    last = max(firsts.values())
    with torch.no_grad():
        _, caches = prefill_slots(params, caches, torch.tensor(prompts, device=dev), lens,
                                  slots, cfg)
        for step in range(last):
            # step s feeds token s and gives the logits of token s + 1
            h, caches = _decode_logits(hidden_params, caches, toks[:, step], lens + step, on,
                                       cfg)
            logits = mm(h, unembed)  # the engine's own [n, V] product
            preds.append(logits.argmax(-1))
            for i, t in firsts.items():
                if t == step + 1:
                    lg16 = logits[i].float()
                    lg32 = h[i].float() @ dense
                    top16, top32 = torch.topk(lg16, 2).values, torch.topk(lg32, 2).values
                    out[i] = ((top32[0] - top32[1]).item(), (top16[0] - top16[1]).item(),
                              top16[0].item())
    off = (torch.stack(preds, 1) != toks[:, 1:last + 1]).sum().item()
    log(f"[spec] the plain run replayed to token {last}: {off} of its tokens differ from the "
        f"replay's argmax")
    return out


def verify_vs_decode_steps(params, prompts, kv_quant) -> tuple[int, int, list[str]]:
    """One verify pass over SPEC_K + 1 tokens a slot against SPEC_K + 1
    decode steps on a copy of the same prefilled slotted cache: (logits
    that differ, logits, cache fields that differ after). Phase 24 wants
    them bit-equal: greedy spec tokens equal plain ones because of it (the
    verify pass runs its MLP down projection a position at a time,
    `_mlp_residual_per_position`), and a cuBLAS that rounds a row apart at
    another M would fail here before the tokens differ."""
    dev = params["embed"].device
    n, s = len(prompts), SPEC_K + 1
    init = init_kv4_cache if kv_quant else init_kv_cache
    lens = torch.tensor([len(p) for p in prompts], device=dev)
    on = torch.ones((n,), dtype=torch.bool, device=dev)
    toks = (torch.arange(n * s, device=dev).reshape(n, s) * 37 + 11) % SPEC_CFG.vocab_size
    with torch.no_grad():
        pair = []
        for _ in range(2):
            caches = [init(n, SPEC_CFG.n_kv_heads, SPEC_CFG.max_seq, SPEC_CFG.head_dim, dev)
                      for _ in range(SPEC_CFG.n_layers)]
            _, caches = prefill_slots(params, caches, torch.tensor(prompts, device=dev), lens,
                                      torch.arange(n, device=dev), SPEC_CFG)
            pair.append(caches)
        got, got_caches = _verify_logits(params, pair[0], toks[:, 0], toks[:, 1:], lens, on,
                                         SPEC_CFG)
        steps, caches = [], pair[1]
        for i in range(s):
            logits, caches = _decode_logits(params, caches, toks[:, i], lens + i, on, SPEC_CFG)
            steps.append(logits)
    off = (got != torch.stack(steps, 1)).sum().item()
    fields_off = [f"layer {i} {name}" for i, (a, b) in enumerate(zip(got_caches, caches))
                  for name, x, y in zip(a._fields, a, b) if not torch.equal(x, y)]
    return off, got.numel(), fields_off


def _verify_parity(eng, label) -> float:
    """One verify pass's logits (every slot active, drafts of the slots' next
    token ids) on copies of the engine's final cache state, on the card
    against the plain path on the CPU; returns their relative L2."""
    cpu_caches = [type(c)(*(x.cpu() for x in c)) for c in eng.caches]
    card_caches = [type(c)(*(x.clone() for x in c)) for c in eng.caches]
    on = torch.ones_like(eng.active)
    draft = (eng.last_tok[:, None] + torch.arange(1, SPEC_K + 1, device=eng.device)) \
        % SPEC_CFG.vocab_size
    with torch.no_grad():
        got, _ = _verify_logits(eng.params, card_caches, eng.last_tok, draft, eng.pos, on,
                                SPEC_CFG)
        ref, _ = _verify_logits(_to(eng.params, "cpu"), cpu_caches, eng.last_tok.cpu(),
                                draft.cpu(), eng.pos.cpu(), on.cpu(), SPEC_CFG)
    got, ref = got.float().cpu(), ref.float()
    rel = ((got - ref).norm() / ref.norm()).item()
    log(f"[spec] {label}: verify logits vs CPU plain path on the final cache state: rel L2 "
        f"{rel:.3e} (tol {LOGITS_REL_TOL})")
    if not (torch.isfinite(got).all() and rel <= LOGITS_REL_TOL):
        raise AssertionError(f"{label}: verify logits disagree with the plain CPU path")
    return rel


def phase_spec_serving(dev, smi) -> dict:
    """Phase 24: the plain engine and spec_decode=SPEC_K on each cache kind.
    Returns each run's launches, keyed by path, the verify wrappers' counts
    under their kernel's row name."""
    params = init_transformer(SPEC_CFG, torch.Generator(device=dev).manual_seed(0), dev,
                              torch.bfloat16)
    prompts = _spec_prompts()
    for kv_quant in (None, "int4"):
        off, total, fields_off = verify_vs_decode_steps(params, prompts, kv_quant)
        log(f"[spec] kv_quant={kv_quant}: a verify pass of {SPEC_K + 1} tokens against "
            f"{SPEC_K + 1} decode steps: {off} of {total} logits differ, cache fields that "
            f"differ: {fields_off}")
        if off or fields_off:
            raise AssertionError(f"kv_quant={kv_quant}: a verify pass is not its decode steps")
    runs = {}
    for suffix, kw in SPEC_KINDS.items():
        row = DECODE_ROW[suffix]
        counter = VERIFY[row][1]
        label = "spec" + "".join(f" {k}={v}" for k, v in kw.items())
        plain_eng, plain, plain_l, plain_wall = _spec_serve(
            dev, params, prompts, label + " plain", decode_horizon=HORIZON, **kw)
        eng, spec, spec_l, spec_wall = _spec_serve(dev, params, prompts, label,
                                                   spec_decode=SPEC_K, **kw)
        st = eng.stats()["spec"]
        used_plain = {k for k, v in plain_l.items() if v}
        used_spec = {k for k, v in spec_l.items() if v}
        if used_plain != {"flash_fwd", row}:
            raise AssertionError(f"{label} plain: launches {plain_l}")
        if used_spec != {"flash_fwd", counter} or \
                spec_l[counter] != SPEC_CFG.n_layers * st["steps"]:
            raise AssertionError(f"{label}: launches {spec_l}, {st['steps']} spec steps")
        if st["accepted"] <= 0:
            raise AssertionError(f"{label}: no draft was accepted")
        same = sum(a == b for a, b in zip(spec, plain))
        firsts = {i: next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
                  for i, (a, b) in enumerate(zip(spec, plain)) if a != b}
        if 0 in firsts.values():
            raise AssertionError(f"{label}: a prefill token differs from the plain engine's")
        gaps = _plain_gaps(eng.params, prompts, plain, firsts, kw.get("kv_quant")) \
            if firsts else {}
        for i, t in firsts.items():
            gap32, gap16, top = gaps[i]
            ulp = 2.0 ** (math.floor(math.log2(abs(top))) - 7) if top else 0.0
            floor = max(SPEC_TIE_GAP, ulp)
            log(f"[spec] {label}: request {i} first differs at token {t} (spec {spec[i][t]}, "
                f"plain {plain[i][t]}); the plain run's top-2 logit gap there {gap32:.4e} "
                f"(f32; bf16 logits {gap16:.4e}, top logit {top:.4f}, one bf16 ulp {ulp:.4e}); "
                f"near-tie floor {floor:.4e}")
            if gap32 >= floor:
                raise AssertionError(f"{label}: spec tokens differ from the plain engine's "
                                     f"away from a near-tie")
        _verify_parity(eng, label)
        n_tok = N_SLOTS * NEW_TOKENS
        log(f"[spec] {label} on {smi}: plain (horizon {HORIZON}) {n_tok / plain_wall:.1f} "
            f"tokens/s, spec (k={SPEC_K}) {n_tok / spec_wall:.1f} tokens/s "
            f"({plain_wall / spec_wall:.3f}x); {st['tokens_per_pass']:.3f} tokens per model "
            f"pass, {st['accepted']} drafts accepted in {st['steps']} steps; {same}/{N_SLOTS} "
            f"requests token-equal to plain; spec launches "
            f"{ {k: v for k, v in spec_l.items() if v} }; plain ledger {plain_eng.ledger()}; "
            f"spec ledger {eng.ledger()}")
        runs[f"spec_plain{suffix}"] = {k: v for k, v in plain_l.items() if v}
        runs[f"serve_spec{suffix}"] = {("flash_fwd" if k == "flash_fwd" else row): v
                                       for k, v in spec_l.items() if v}
    return runs


# --------------------------------------------------------------------------
# Chunked prefill, the prefix cache, top-k / top-p sampling, adaptive horizons
# --------------------------------------------------------------------------

CHUNK, LONG_LEN = 256, 1000
# _merge_partials on the card against the CPU: the same f32 operations, so
# only exp2 / log2 may round apart (one ulp)
MERGE_TOL = 1e-6
# bench.py:bench_prefix_cache: 8 slots x (768 shared + 64 tail), 32 new
# tokens, paged (pages of 128), chunks of 256, max_seq = prompt + 256
PREFIX_SHARED, PREFIX_TAIL, PREFIX_NEW = 768, 64, 32
PREFIX_CFG = dataclasses.replace(BENCH_CFG, max_seq=PREFIX_SHARED + PREFIX_TAIL + 256)
FILTER_SPECS = (Sampling(0.8, 50, 0.9), Sampling(1.0, 0, 0.5), Sampling(1.0, 8192, 0.999),
                Sampling(0.7, 1, 1.0), Sampling(1.3, 400, 0.95))


def _chunk_b1(dev, gen) -> dict:
    """B1 at a chunk's shapes: causal on the chunk itself, bf16 (1, 16, 256,
    64), and non-causal from the chunk's bf16 q to f32 dequantized prefixes
    of 256, 512 and 768 tokens (one kv_to_bf16 launch a call), each against
    its plain version; `_merge_partials` on the card against the CPU; then
    B1 timed at the 768-token prefix beside its plain version and SDPA."""
    q, k, v = (torch.randn((1, 16, CHUNK, 64), generator=gen, device=dev, dtype=torch.bfloat16)
               for _ in range(3))
    worst = _check_flash(q, k, v, True, "chunk (1,16,256,64) causal, bf16 in")
    for s in (256, 512, 768):
        kp, vp = (torch.randn((1, 16, s, 64), generator=gen, device=dev) for _ in range(2))
        worst = max(worst, _check_flash(q, kp, vp, False, f"chunk q bf16 (1,16,256,64) to an f32 "
                                                          f"prefix of {s}, non-causal"))
    o1, o2 = (torch.randn((1, 16, CHUNK, 64), generator=gen, device=dev) for _ in range(2))
    lse1, lse2 = (torch.randn((1, 16, CHUNK), generator=gen, device=dev) * 4 for _ in range(2))
    lse1[0, 0, :7] = -torch.inf
    lse2[0, 1, 3:9] = -torch.inf
    lse1[0, 2, 10:14] = lse2[0, 2, 10:14] = -torch.inf
    got_o, got_l = (x.cpu() for x in _merge_partials(o1, lse1, o2, lse2))
    want_o, want_l = _merge_partials(*(x.cpu() for x in (o1, lse1, o2, lse2)))
    empty = torch.isneginf(want_l)
    err = max((got_o - want_o).abs().max().item(), (got_l - want_l)[~empty].abs().max().item())
    log(f"[chunk] _merge_partials on the card vs the CPU: max diff {err:.3e} (tol {MERGE_TOL}), "
        f"{int(empty.sum())} rows with both lse -inf")
    if not (err <= MERGE_TOL and torch.equal(torch.isneginf(got_l), empty)
            and bool((got_o[empty] == 0).all())):
        raise AssertionError("_merge_partials on the card differs from the CPU")
    ms = device_ms(lambda: flash_attention_fwd(q, kp, vp, causal=False))
    plain_ms = device_ms(lambda: flash_attention_fwd_plain(q, kp, vp, causal=False))
    kb, vb = kp.to(torch.bfloat16), vp.to(torch.bfloat16)
    lib_ms = device_ms(lambda: F.scaled_dot_product_attention(q, kb, vb))
    o, lse = flash_attention_fwd(q, kp, vp, causal=False)
    flops = 2 * 2 * 16 * CHUNK * 768 * 64
    call = bound(nbytes(q, kp, vp, o, lse), (flops, PEAK_BF16))
    kernel = bound(nbytes(q, kb, vb, o, lse), (flops, PEAK_BF16))
    log(f"[chunk] B1 non-causal (1,16,256,64) x 768 f32 prefix: call {ms:.4f} ms (kv_to_bf16 + "
        f"kernel), plain {plain_ms:.4f} ms, sdpa (bf16 K/V) {lib_ms:.4f} ms; bound {call['bound_ms']:.4f}"
        f" ms with f32 K/V in, {kernel['bound_ms']:.4f} ms with bf16 K/V ({kernel['bound_by']})")
    return {"chunk_max_abs_err": worst, "chunk_prefix_ms": ms, "chunk_prefix_plain_ms": plain_ms,
            "chunk_prefix_bound_ms": call["bound_ms"], "chunk_prefix_bound_by": call["bound_by"],
            "chunk_prefix_kernel_bound_ms": kernel["bound_ms"], "chunk_prefix_library_ms": lib_ms,
            "chunk_prefix_shape": "q bf16 (1,16,256,64), K/V f32 (1,16,768,64), non-causal"}


def _chunk_prompts() -> list:
    """4 prompts of 256 tokens and 4 of 1000, alternating, so each long
    prompt's chunks run while earlier requests decode."""
    rng = np.random.default_rng(1)
    return [rng.integers(1, BENCH_CFG.vocab_size, size=PROMPT_LEN if i % 2 == 0 else LONG_LEN)
            .tolist() for i in range(N_SLOTS)]


def _kind_caches(dev, kw):
    """Fresh one-row caches of the cache kind `kw` at BENCH_CFG's capacity
    (a paged row owns pages 1 .. 10)."""
    cfg, pages = BENCH_CFG, BENCH_CFG.max_seq // PAGE
    if kw.get("cache") == "paged":
        init = init_paged4_cache if kw.get("kv_quant") == "int4" else init_paged_cache
        caches = [init(cfg.n_kv_heads, 1 + pages, 1, pages, cfg.head_dim, PAGE, dev)
                  for _ in range(cfg.n_layers)]
        row = torch.arange(1, 1 + pages, dtype=torch.int32, device=dev)
        return [assign_pages(c, 0, row) for c in caches]
    init = init_kv4_cache if kw.get("kv_quant") == "int4" else init_kv_cache
    return [init(1, cfg.n_kv_heads, cfg.max_seq, cfg.head_dim, dev) for _ in range(cfg.n_layers)]


def _chunk_logit_parity(dev, params, prompt, kw, label) -> float:
    """The last chunk's logits of `prompt`, chunk by chunk into fresh caches
    of the kind, on the card against the plain path on the CPU."""

    def last_logits(device, p):
        caches = _kind_caches(device, kw)
        n = -(-len(prompt) // CHUNK)
        for i in range(n):
            piece = prompt[i * CHUNK:(i + 1) * CHUNK]
            tokens = torch.tensor(piece + [0] * (CHUNK - len(piece)), device=device)
            logits, caches = prefill_chunk_logits(p, caches, tokens, i * CHUNK, len(prompt), 0,
                                                  BENCH_CFG, i == n - 1)
        return logits.float().cpu()

    got, ref = last_logits(dev, params), last_logits("cpu", _to(params, "cpu"))
    rel = ((got - ref).norm() / ref.norm()).item()
    log(f"[chunk] {label}: last-chunk logits of a {len(prompt)}-token prompt vs the CPU plain "
        f"path: rel L2 {rel:.3e} (tol {LOGITS_REL_TOL}), argmax equal {bool(got.argmax() == ref.argmax())}")
    if not (torch.isfinite(got).all() and rel <= LOGITS_REL_TOL):
        raise AssertionError(f"{label}: chunked-prefill logits disagree with the CPU plain path")
    return rel


def _serve_once(dev, params, prompts, label, **kw):
    """One run of `prompts` (NEW_TOKENS each) on a fresh engine at
    BENCH_CFG with the engine options `kw`: (tokens, the launches counted
    over the run, wall seconds, the engine, its action sequence, the
    results). Each request must get its budget of in-vocab tokens."""
    eng = ServingEngine(params, BENCH_CFG, dev, n_slots=N_SLOTS, scheduler="native",
                        decode_horizon=HORIZON, **kw)
    events = []
    real_chunk, real_decode = eng._do_prefill_chunk, eng._do_decode

    def chunk():
        events.append(("chunk", eng._pending["rid"], eng._pending["next"]))
        real_chunk()

    def decode():
        events.append(("decode", sum(r >= 0 for r in eng._slot_req), None))
        real_decode()

    eng._do_prefill_chunk, eng._do_decode = chunk, decode
    rids = [eng.submit(p, NEW_TOKENS) for p in prompts]
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in _launch_counts().items() if v}
    results = [out[r] for r in rids]
    for r in results:
        if len(r.tokens) != NEW_TOKENS or not all(0 <= t < BENCH_CFG.vocab_size for t in r.tokens):
            raise AssertionError(f"{label}: request {r.request_id} gave {len(r.tokens)} tokens")
    return [r.tokens for r in results], launches, wall, eng, events, results


def _chunk_serving(dev, smi, params) -> dict:
    """The chunked engine (prefill_chunk 256, horizon 32) on 4 x 256 + 4 x
    1000-token prompts, on each cache kind: the last chunk's logits against
    the CPU, B1 launched 7 times a layer for a long prompt and once a layer
    for each one-shot prefill, decode banks between every two chunks of
    each long prompt, tokens set beside the one-shot engine's (reported,
    not gated: the chunked path reads its prefix back quantized, so a
    near-tie may flip). Returns each kind's launches by path."""
    prompts = _chunk_prompts()
    long_rids = [i for i, p in enumerate(prompts) if len(p) > CHUNK]
    n_chunks = -(-LONG_LEN // CHUNK)
    # one-shot prefills: each short prompt is served before the next long one
    want_b1 = BENCH_CFG.n_layers * (len(long_rids) * (2 * n_chunks - 1)
                                    + N_SLOTS - len(long_rids))
    _serve_once(dev, params, prompts, "warm-up", prefill_chunk=CHUNK)
    runs = {}
    for suffix, kw in SPEC_KINDS.items():
        label = "chunked" + "".join(f" {k}={v}" for k, v in kw.items())
        _chunk_logit_parity(dev, params, prompts[long_rids[0]], kw, label)
        tokens, launches, wall, eng, events, results = _serve_once(
            dev, params, prompts, label, prefill_chunk=CHUNK, **kw)
        one_shot, _, wall1, _, _, res1 = _serve_once(dev, params, prompts, label + " one-shot",
                                                      **kw)
        row = DECODE_ROW[suffix]
        if set(launches) != {"flash_fwd", row} or launches["flash_fwd"] != want_b1:
            raise AssertionError(f"{label}: launches {launches}, want flash_fwd {want_b1} and {row}")
        between = []
        for rid in long_rids:
            at = [i for i, e in enumerate(events) if e[0] == "chunk" and e[1] == rid]
            banks = [e for e in events[at[0]:at[-1]] if e[0] == "decode" and e[1] > 0]
            if len(at) != n_chunks or not banks:
                raise AssertionError(f"{label}: request {rid} ran {len(at)} chunks with "
                                     f"{len(banks)} decode banks between them")
            between.append(len(banks))
        same = sum(a == b for a, b in zip(tokens, one_shot))
        flat = [(a, b) for x, y in zip(tokens, one_shot) for a, b in zip(x, y)]
        ttft = statistics.median(r.ttft_s for r in results) * 1e3
        ttft1 = statistics.median(r.ttft_s for r in res1) * 1e3
        log(f"[chunk] {label} on {smi}: {N_SLOTS * NEW_TOKENS / wall:.1f} tokens/s, median TTFT "
            f"{ttft:.2f} ms (one-shot {N_SLOTS * NEW_TOKENS / wall1:.1f} tokens/s, {ttft1:.2f} ms); "
            f"launches {launches}; decode banks between each long prompt's first and last "
            f"chunk {between}; {same}/{N_SLOTS} requests and "
            f"{sum(a == b for a, b in flat) / len(flat):.3f} of the tokens equal the one-shot "
            f"engine's (not gated)")
        runs[f"serve_chunked{suffix}"] = launches
    return runs


def _prefix_waves() -> list:
    rng = np.random.default_rng(0)
    prefix = rng.integers(1, PREFIX_CFG.vocab_size, size=PREFIX_SHARED).tolist()
    return [[prefix + rng.integers(1, PREFIX_CFG.vocab_size, size=PREFIX_TAIL).tolist()
             for _ in range(N_SLOTS)] for _ in range(2)]


def _prefix_engine(dev, smi, params, waves, prefix_cache) -> list:
    """bench_prefix_cache's engine, its two waves one after another: each
    wave's tokens, launches, tokens/s, median TTFT and prefix hit pages."""
    eng = ServingEngine(params, PREFIX_CFG, dev, n_slots=N_SLOTS, scheduler="native",
                        cache="paged", page_size=PAGE, prefill_chunk=CHUNK,
                        decode_horizon=PREFIX_NEW, prefix_cache=prefix_cache)
    out = []
    for wave in waves:
        hits = eng.stats().get("prefix_hit_pages", 0)
        rids = [eng.submit(p, PREFIX_NEW) for p in wave]
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        res = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = eng.stats()
        out.append({"tokens": [res[r].tokens for r in rids],
                    "launches": {k: v for k, v in _launch_counts().items() if v},
                    "tokens_per_s": sum(len(res[r].tokens) for r in rids) / wall,
                    "ttft_ms": statistics.median(res[r].ttft_s for r in rids) * 1e3,
                    "hit_pages": st.get("prefix_hit_pages", 0) - hits,
                    "nodes": st.get("prefix_nodes"), "pages_free": st["pages_free"]})
    if prefix_cache and out[-1]["pages_free"] + out[-1]["nodes"] != eng.caches[0].n_pages - 1:
        raise AssertionError(f"prefix engine: {out[-1]['pages_free']} pages free and "
                             f"{out[-1]['nodes']} cached of {eng.caches[0].n_pages - 1}")
    return out


def _prefix_serving(dev, smi, params) -> dict:
    """bench_prefix_cache's traffic, cold (no prefix cache) then warm: the
    warm engine's tokens equal the cold one's bit for bit (the same chunk
    grid, so the same bits in the shared pages), wave 2 hits 6 pages a
    request, B1 runs 7 times a layer a request cold and 2 warm."""
    waves = _prefix_waves()
    n_chunks = -(-(PREFIX_SHARED + PREFIX_TAIL) // CHUNK)
    cold = _prefix_engine(dev, smi, params, waves, False)
    warm = _prefix_engine(dev, smi, params, waves, True)
    want_cold = PREFIX_CFG.n_layers * N_SLOTS * (2 * n_chunks - 1)
    want_warm = PREFIX_CFG.n_layers * N_SLOTS * 2
    want_hits = N_SLOTS * (PREFIX_SHARED // PAGE)
    for w in range(2):
        log(f"[prefix] wave {w + 1} on {smi}: cold {cold[w]['tokens_per_s']:.1f} tokens/s, median "
            f"TTFT {cold[w]['ttft_ms']:.2f} ms, launches {cold[w]['launches']}; warm "
            f"{warm[w]['tokens_per_s']:.1f} tokens/s, median TTFT {warm[w]['ttft_ms']:.2f} ms, "
            f"launches {warm[w]['launches']}, hit pages {warm[w]['hit_pages']}, nodes "
            f"{warm[w]['nodes']}, pages free {warm[w]['pages_free']}")
        if warm[w]["tokens"] != cold[w]["tokens"]:
            raise AssertionError(f"prefix wave {w + 1}: warm tokens differ from the cold engine's")
        if cold[w]["launches"].get("flash_fwd") != want_cold:
            raise AssertionError(f"prefix wave {w + 1}: the cold engine launched B1 "
                                 f"{cold[w]['launches'].get('flash_fwd')} times, want {want_cold}")
    if warm[1]["hit_pages"] != want_hits or warm[1]["launches"].get("flash_fwd") != want_warm:
        raise AssertionError(f"prefix wave 2: {warm[1]['hit_pages']} hit pages (want {want_hits}), "
                             f"B1 {warm[1]['launches'].get('flash_fwd')} launches (want {want_warm})")
    if set(warm[1]["launches"]) != {"flash_fwd", "paged_decode"}:
        raise AssertionError(f"prefix wave 2 launched {warm[1]['launches']}")
    log(f"[prefix] wave 2, warm against cold on {smi}: tokens/s "
        f"{warm[1]['tokens_per_s'] / cold[1]['tokens_per_s']:.3f}x, median TTFT "
        f"{cold[1]['ttft_ms'] / warm[1]['ttft_ms']:.3f}x faster; tokens equal bit for bit")
    return {"serve_prefix_cold": cold[1]["launches"], "serve_prefix_warm": warm[1]["launches"]}


def _sampling_serving(dev, smi, bf16_tokens) -> dict:
    """top_k = 1 at temperature 1 serves the greedy engine's tokens (with
    f32 params: bf16 logits tie exactly often enough that top-k keeps two
    ids, in JAX as here); a temperature 0.8, top_k 50, top_p 0.9 engine
    repeats its tokens under the same seed; `_filter_logits` on the card
    equals the CPU's bit for bit; adaptive_horizon=32 serves phase 5's
    tokens."""
    gen = torch.Generator(device=dev).manual_seed(7)
    logits = torch.randn((N_SLOTS, BENCH_CFG.vocab_size), generator=gen, device=dev) * 3
    logits[:, :40] = logits[:, :1]  # a tie across the top-k and top-p cuts
    for spec in FILTER_SPECS:
        scaled = logits / spec.temperature
        got, want = _filter_logits(scaled, spec).cpu(), _filter_logits(scaled.cpu(), spec)
        if not torch.equal(got, want):
            raise AssertionError(f"_filter_logits {spec} on the card differs from the CPU")
    log(f"[sampling] _filter_logits on the card equals the CPU bit for bit at {len(FILTER_SPECS)} "
        f"specs on [{N_SLOTS}, {BENCH_CFG.vocab_size}] logits")
    runs = {}
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, BENCH_CFG.vocab_size, size=PROMPT_LEN).tolist()
               for _ in range(N_SLOTS)]
    f32 = init_transformer(BENCH_CFG, torch.Generator(device=dev).manual_seed(0), dev)
    greedy = _serve_once(dev, f32, prompts, "greedy, f32")[0]
    k1, runs["serve_top_k1"], *_ = _serve_once(dev, f32, prompts, "top_k=1, f32",
                                              temperature=1.0, top_k=1, seed=3)
    if k1 != greedy:
        raise AssertionError("top_k=1 at temperature 1 differs from the greedy engine")
    log(f"[sampling] f32 params: top_k=1 at temperature 1 serves the greedy engine's "
        f"{N_SLOTS} x {NEW_TOKENS} tokens; launches {runs['serve_top_k1']}")
    params = init_transformer(BENCH_CFG, torch.Generator(device=dev).manual_seed(0), dev,
                              torch.bfloat16)
    sampled = [_serve_once(dev, params, prompts, "top-k / top-p", temperature=0.8, top_k=50,
                           top_p=0.9, seed=5)[0] for _ in range(2)]
    if sampled[0] != sampled[1]:
        raise AssertionError("the top-k / top-p engine did not repeat its tokens under its seed")
    flat = [(a, b) for x, y in zip(sampled[0], bf16_tokens) for a, b in zip(x, y)]
    log(f"[sampling] temperature 0.8, top_k 50, top_p 0.9, seed 5: repeats itself; "
        f"{sum(a == b for a, b in flat) / len(flat):.3f} of its tokens equal the greedy ones")
    tokens, launches, _, _ = _serve(dev, smi, BENCH_CFG, adaptive_horizon=HORIZON)
    if tokens != bf16_tokens:
        raise AssertionError("adaptive_horizon=32 differs from the fixed-horizon engine")
    runs["serve_adaptive"] = {k: v for k, v in launches.items() if v}
    log(f"[sampling] adaptive_horizon={HORIZON}: tokens equal phase 5's; launches "
        f"{runs['serve_adaptive']}")
    return runs


def phase_chunked_prefix_serving(dev, gen, smi, bf16_tokens) -> tuple[dict, dict]:
    """Phase 25: B1 at the chunk shapes, the chunked engine on the four cache
    kinds, the prefix cache on bench_prefix_cache's traffic, top-k / top-p
    sampling and adaptive horizons. Returns (B1's timing at the chunk's
    prefix shape, each run's launches by path)."""
    b1 = _chunk_b1(dev, gen)
    params = init_transformer(BENCH_CFG, torch.Generator(device=dev).manual_seed(0), dev,
                              torch.bfloat16)
    runs = _chunk_serving(dev, smi, params)
    runs.update(_prefix_serving(dev, smi, params))
    runs.update(_sampling_serving(dev, smi, bf16_tokens))
    return b1, runs


def _to(params, device):
    """A detached copy of an LM params dict on `device` (quantized weights
    move with their payloads and scales as they are)."""

    def move(v):
        return v.to(device) if isinstance(v, (QuantizedWeight, QuantizedWeight4)) \
            else v.detach().to(device)

    out = {k: move(v) for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: move(v) for k, v in lay.items()} for lay in params["layers"]]
    return out


# --------------------------------------------------------------------------
# Training
# --------------------------------------------------------------------------

# The oracle envelope is held on per-head gradients (rep 1) at half a
# million elements a tensor, where a mismatch rate is stable (at 3e4
# elements, as in the JAX package's CPU test, one seed's count swings
# between 2 and 12), on the cross case (rep 2) and on GQA rep 4 with a
# ragged tile.
ORACLE_CASES = [(2, 16, 16, 256, 256, True), (2, 16, 16, 256, 256, False),
                (1, 4, 2, 77, 201, False), (2, 16, 4, 1000, 1000, True)]


def _qkvdo(gen, dev, b, h, h_kv, t, s, d=64):
    return (torch.randn((b, h, t, d), generator=gen, device=dev),
            torch.randn((b, h_kv, s, d), generator=gen, device=dev),
            torch.randn((b, h_kv, s, d), generator=gen, device=dev),
            torch.randn((b, h, t, d), generator=gen, device=dev))


# shapes the forward cases do not reach: a rep that does not divide 64, rep 64
# (one row per group in a dQ block), a single token, causal with t < s
BWD_EDGE_CASES = [(2, 6, 2, 33, 130, True), (1, 64, 1, 70, 70, True), (1, 3, 1, 1, 1, True)]
# the fast kernels' tile edges (128-key B2 blocks, 128-row B3 blocks, 64-row
# tiles through rings of 4 stages): t and s off a multiple of 128, causal t <
# s and t > s, rep 3, 5, 8 and 128 (one position a B3 block), one 128-key
# tile, and more q tiles (B2) and key tiles (B3) than stages; inputs from a
# generator of their own, as the one-token case's 16 seeds
BWD_TILE_CASES = [(1, 4, 4, 200, 330, True), (1, 4, 4, 330, 200, True), (1, 6, 2, 300, 300, True),
                  (1, 10, 2, 77, 201, False), (1, 16, 2, 300, 300, True),
                  (1, 128, 1, 40, 300, True), (1, 2, 2, 128, 128, True),
                  (1, 2, 2, 1280, 1280, False), (1, 2, 2, 1280, 1280, True)]
ONE_TOKEN_SEEDS = 16
# fast mode's prep launch against its plain version: q_s, dO_s, K and V byte
# for byte; D within PREP_D_TOL of max|D| (the plain prep sums the products in
# the kernel's order, so 0 is expected; the tolerance leaves room for the
# order of the f32 sum)
PREP_D_TOL = 1e-6


def _check_bwd(ops, label: str) -> dict:
    """B2 and B3 on `ops` against their plain versions, max|diff| /
    max|plain| per tensor within the mode's tolerance (raises otherwise), and
    the same bits from a second call. Returns each kernel's max|diff|."""
    tol = BWD_FAST_TOL if ops.fast else BWD_EXACT_TOL
    dk, dv = flash_bwd_dkv(ops)
    dq = flash_bwd_dq(ops)
    dk2, dv2 = flash_bwd_dkv(ops)
    dq2 = flash_bwd_dq(ops)
    torch.cuda.synchronize()
    if not (torch.equal(dk, dk2) and torch.equal(dv, dv2) and torch.equal(dq, dq2)):
        raise AssertionError(f"flash_bwd gave other bits on a second call at {label}")
    dk_p, dv_p = flash_bwd_dkv_plain(ops)
    dq_p = flash_bwd_dq_plain(ops)
    rel, err = {}, {"flash_bwd_dkv": 0.0, "flash_bwd_dq": 0.0}
    for name, got, want in (("dq", dq, dq_p), ("dk", dk, dk_p), ("dv", dv, dv_p)):
        if not torch.isfinite(got).all():
            raise AssertionError(f"flash_bwd {name} is not finite")
        diff = (got - want).abs().max().item()
        rel[name] = diff / want.abs().max().item()
        kernel = "flash_bwd_dq" if name == "dq" else "flash_bwd_dkv"
        err[kernel] = max(err[kernel], diff)
    log(f"[flash_bwd] {label} {'fast' if ops.fast else 'exact'}: max|diff|/max|plain| dq "
        f"{rel['dq']:.3e} dk {rel['dk']:.3e} dv {rel['dv']:.3e} (tol {tol})")
    if max(rel.values()) > tol:
        raise AssertionError("flash_bwd kernels disagree with their plain versions")
    return err


def _worst(*errs: dict) -> dict:
    return {k: max(e[k] for e in errs) for k in errs[0]}


def _check_prep(q, k, v, o, lse, do, causal, label) -> float:
    """Fast mode's prep launches (bwd_prep for q_s, dO_s, lse and D;
    kv_to_bf16 for f32 K and V) against the plain prep on the same inputs:
    q_s, dO_s, lse, K and V byte-equal, D within PREP_D_TOL of max|D|.
    Returns D's max|diff| / max|D|."""
    got = bwd_operands(q, k, v, o, lse, do, causal=causal, fast=True)
    want = bwd_operands(q, k, v, o, lse, do, causal=causal, fast=True, plain=True)
    for name in ("q", "do", "k", "v", "lse"):
        if not torch.equal(getattr(got, name), getattr(want, name)):
            raise AssertionError(f"flash_bwd prep: {name} differs from the plain prep at {label}")
    rel = ((got.di - want.di).abs().max() / want.di.abs().max()).item()
    if not rel <= PREP_D_TOL:
        raise AssertionError(f"flash_bwd prep: D {rel:.3e} of max|D| from the plain prep at "
                             f"{label} (tol {PREP_D_TOL})")
    return rel


def _bwd_case(q, k, v, do, causal, label, modes=(True, False)) -> tuple[list, float]:
    """The kernels of both modes (fast=True, False; `modes`) against their
    plain versions on B1's O and lse of (q, k, v); the fast prep against its
    plain version; the whole fast call on [b, t, h, d] views equal bit for
    bit to the call on contiguous inputs. Returns (the modes' errors, the
    prep's D error)."""
    o, lse = flash_attention_fwd(q, k, v, causal=causal)
    errs = [_check_bwd(bwd_operands(q, k, v, o, lse, do, causal=causal, fast=fast), label)
            for fast in modes]
    d_rel = _check_prep(*_strided(q, k, v, o), lse, *_strided(do), causal, label)
    got = flash_attention_bwd(*_strided(q, k, v, o), lse, *_strided(do), causal=causal, fast=True)
    want = flash_attention_bwd(q, k, v, o, lse, do, causal=causal, fast=True)
    torch.cuda.synchronize()
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"flash_attention_bwd on [b, t, h, d] views differs from "
                             f"contiguous inputs at {label}")
    return errs, d_rel


def phase_flash_bwd(dev, gen) -> dict:
    errs, d_rel = [], 0.0
    edge_gen = torch.Generator(device=dev).manual_seed(12)
    cases = [(c, gen) for c in FLASH_CASES + BWD_EDGE_CASES] \
        + [(c, edge_gen) for c in BWD_TILE_CASES]
    first_draw = len(cases)
    cases += [(BWD_EDGE_CASES[-1], edge_gen)] * ONE_TOKEN_SEEDS
    # the train-GQA phase's attention shape, as its model hands it in
    cases += [((GQA_BATCH, GQA_CFG.n_heads, GQA_CFG.n_kv_heads, GQA_CFG.max_seq, GQA_CFG.max_seq,
                True), torch.Generator(device=dev).manual_seed(13))]
    for i, ((b, h, h_kv, t, s, causal), g) in enumerate(cases):
        label = f"b={b} h={h} h_kv={h_kv} t={t} s={s} causal={causal}"
        if first_draw <= i < first_draw + ONE_TOKEN_SEEDS:
            label += f" (draw {i - first_draw + 1} of {ONE_TOKEN_SEEDS})"
        e, d = _bwd_case(*_qkvdo(g, dev, b, h, h_kv, t, s), causal, label)
        errs += e
        d_rel = max(d_rel, d)
    log(f"[flash_bwd] prep launch: q_s, dO_s, lse, K and V byte-equal to the plain prep at every "
        f"case; D max|diff|/max|D| {d_rel:.3e} (tol {PREP_D_TOL})")

    # autograd through flash_attention_bf16 vs the fp32 oracle: the JAX
    # package's envelope (atol 1e-2, mismatch rate <= 3.5e-4), whose atol is
    # per head. A GQA dk/dv sums rep heads' gradients, and in fast mode each
    # head's term carries its own bf16 rounding of P and dS, so fast dk/dv are
    # held at rep x atol; exact mode holds the per-head atol everywhere.
    for case in ORACLE_CASES:
        b, h, h_kv, t, s, causal = case
        q, k, v, do = _qkvdo(gen, dev, b, h, h_kv, t, s)
        want = reference_attention_vjp(q, k, v, do, causal=causal)
        for exact in (False, True):
            leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
            got = torch.autograd.grad(
                flash_attention_bf16(*leaves, causal=causal, bwd_exact=exact), leaves, do)
            kv_atol = ATOL if exact else ATOL * (h // h_kv)
            reps = [mismatch_report(n, g, w, atol) for n, g, w, atol
                    in zip(("dq", "dk", "dv"), got, want, (ATOL, kv_atol, kv_atol))]
            log(f"[flash_bwd] autograd vs fp32 oracle {case} bwd_exact={exact}: "
                + "; ".join(map(str, reps)))
            if max(r.mismatch_rate for r in reps) > GRAD_MISMATCH_RATE:
                raise AssertionError("flash_attention_bf16 gradients outside the envelope")
    return _worst(*errs)


# B2 and B3 are also timed at GQA rep 4: (b, h, h_kv, t), causal
BWD_GQA = (2, 16, 4, 2048)


def _bwd_call_times(q, k, v, o, lse, do) -> tuple[dict, dict]:
    """The whole fast `flash_attention_bwd` call at the training shape on the
    model's inputs ([b, h, t, 64] views of [b, t, h, 64] f32 tensors): its
    prep launches held against the plain prep (`_check_prep`) and the call
    against `flash_attention_bwd_plain` (BWD_FAST_TOL of max|plain| per
    tensor), then the call's time, its prep's and the plain prep's. Returns
    (times, each kernel's max|diff| of the call against the plain call)."""
    qv, kv, vv, ov, dov = _strided(q, k, v, o, do)
    label = f"{tuple(q.shape)} causal on [b, t, h, d] views"
    d_rel = _check_prep(qv, kv, vv, ov, lse, dov, True, label)
    got = flash_attention_bwd(qv, kv, vv, ov, lse, dov, causal=True, fast=True)
    want = flash_attention_bwd_plain(qv, kv, vv, ov, lse, dov, causal=True, fast=True)
    torch.cuda.synchronize()
    rel, err = {}, {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        if not torch.isfinite(g).all():
            raise AssertionError(f"flash_attention_bwd {name} is not finite at {label}")
        diff = (g - w).abs().max().item()
        rel[name] = diff / w.abs().max().item()
        kernel = "flash_bwd_dq" if name == "dq" else "flash_bwd_dkv"
        err[kernel] = max(err.get(kernel, 0.0), diff)
    log(f"[flash_bwd] {label}: prep launches byte-equal to the plain prep (D "
        f"max|diff|/max|D| {d_rel:.3e}, tol {PREP_D_TOL}); the whole fast call vs "
        f"flash_attention_bwd_plain max|diff|/max|plain| dq {rel['dq']:.3e} dk {rel['dk']:.3e} "
        f"dv {rel['dv']:.3e} (tol {BWD_FAST_TOL})")
    if max(rel.values()) > BWD_FAST_TOL:
        raise AssertionError(f"flash_attention_bwd disagrees with its plain version at {label}")
    del got, want
    call_ms = device_ms(lambda: flash_attention_bwd(qv, kv, vv, ov, lse, dov, causal=True,
                                                    fast=True))
    prep_ms = device_ms(lambda: bwd_operands(qv, kv, vv, ov, lse, dov, causal=True, fast=True))
    prep_plain_ms = device_ms(lambda: bwd_operands(qv, kv, vv, ov, lse, dov, causal=True,
                                                   fast=True, plain=True))
    log(f"[timing] flash_attention_bwd (fast) on the model's f32 [b, t, h, d] views at "
        f"{tuple(q.shape)} causal: call {call_ms:.4f} ms, of which the prep launches "
        f"{prep_ms:.4f} ms ({prep_ms / call_ms:.1%}); the plain prep (torch ops) "
        f"{prep_plain_ms:.4f} ms")
    return ({"call_ms": call_ms, "prep_ms": prep_ms, "prep_plain_ms": prep_plain_ms,
             "prep_d_rel": d_rel}, err)


def _bwd_gqa_times(q, k, v, do) -> dict:
    """B2 and B3 (fast) at a GQA shape, causal: device time and bound of
    each, beside SDPA's bf16 backward (K/V repeated over the group)."""
    (b, h, t, d), h_kv = q.shape, k.shape[1]
    o, lse = flash_attention_fwd(q, k, v, causal=True)
    ops = bwd_operands(q, k, v, o, lse, do, causal=True, fast=True)
    dk, dv = flash_bwd_dkv(ops)
    dq = flash_bwd_dq(ops)
    pairs = b * h * visible_pairs(t, t, True)
    lib_ms = _sdpa_bwd_ms(q, k, v, do)
    out = {"flash_bwd_dkv": {"gqa_ms": device_ms(lambda: flash_bwd_dkv(ops)),
                             **bound(nbytes(*ops[:6], dk, dv), (4 * 2 * pairs * d, PEAK_BF16))},
           "flash_bwd_dq": {"gqa_ms": device_ms(lambda: flash_bwd_dq(ops)),
                            **bound(nbytes(*ops[:6], dq), (3 * 2 * pairs * d, PEAK_BF16))}}
    pair_ms = out["flash_bwd_dkv"]["gqa_ms"] + out["flash_bwd_dq"]["gqa_ms"]
    shape = f"({b},{h}q/{h_kv}kv,{t},{d})"
    for name, r in out.items():
        r["gqa_bound_ms"], r["gqa_bound_by"] = r.pop("bound_ms"), r.pop("bound_by")
        r["gqa_library_ms"], r["gqa_shape"] = lib_ms, f"{shape} causal"
        log(f"[timing] {name} at {shape} causal: kernel {r['gqa_ms']:.4f} ms, bound "
            f"{r['gqa_bound_ms']:.4f} ms ({r['gqa_bound_by']})")
    log(f"[timing] flash backward at {shape} causal: B2 + B3 {pair_ms:.4f} ms, sdpa bf16 "
        f"backward {lib_ms:.4f} ms, ratio {pair_ms / lib_ms:.3f}")
    return out


def phase_train_timing(dev, gen) -> tuple[dict, dict]:
    """At the training shape, causal, f32 inputs as the model hands them in:
    B1, B2 and B3 (both modes) against their plain versions, then device
    time per call; bf16 for the library call. Returns (times and bounds,
    each kernel's max|diff| against its plain version)."""
    b, h, t, d = TRAIN_BATCH, 16, TRAIN_CFG.max_seq, 64
    q, k, v, do = _qkvdo(gen, dev, b, h, h, t, t)
    o, lse = flash_attention_fwd(q, k, v, causal=True)
    torch.cuda.synchronize()
    o_p, lse_p = flash_attention_fwd_plain(q, k, v, causal=True)
    err_o = (o - o_p).abs().max().item()
    err_l = (lse - lse_p).abs().max().item()
    log(f"[flash_fwd] ({b},{h},{t},{d}) causal, f32 in: max|dO|={err_o:.3e} (tol {FLASH_O_TOL}) "
        f"max|dlse|={err_l:.3e} (tol {FLASH_LSE_TOL})")
    if not (err_o <= FLASH_O_TOL and err_l <= FLASH_LSE_TOL):
        raise AssertionError("flash_fwd kernel disagrees with its plain version")
    del o_p, lse_p
    fast = bwd_operands(q, k, v, o, lse, do, causal=True, fast=True)
    exact = bwd_operands(q, k, v, o, lse, do, causal=True, fast=False)
    label = f"({b},{h},{t},{d}) causal"
    errs = {"flash_fwd": err_o, **_worst(_check_bwd(fast, label), _check_bwd(exact, label))}
    dk, dv = flash_bwd_dkv(fast)
    dq = flash_bwd_dq(fast)
    pairs = b * h * visible_pairs(t, t, True)
    out = {
        "flash_fwd": {"ms": device_ms(lambda: flash_attention_fwd(q, k, v, causal=True)),
                      "plain_ms": device_ms(lambda: flash_attention_fwd_plain(q, k, v, True),
                                            calls=4, replays=5),
                      **bound(nbytes(q, k, v, o, lse), (2 * 2 * pairs * d, PEAK_BF16))},
        "flash_bwd_dkv": {
            "ms": device_ms(lambda: flash_bwd_dkv(fast)),
            "plain_ms": device_ms(lambda: flash_bwd_dkv_plain(fast), calls=4, replays=5),
            "exact_ms": device_ms(lambda: flash_bwd_dkv(exact), calls=4, replays=5),
            **bound(nbytes(*fast[:6], dk, dv), (4 * 2 * pairs * d, PEAK_BF16)),
            "exact_bound_ms": bound(nbytes(*exact[:6], dk, dv),
                                    (4 * 2 * pairs * d, PEAK_FP32))["bound_ms"]},
        "flash_bwd_dq": {
            "ms": device_ms(lambda: flash_bwd_dq(fast)),
            "plain_ms": device_ms(lambda: flash_bwd_dq_plain(fast), calls=4, replays=5),
            "exact_ms": device_ms(lambda: flash_bwd_dq(exact), calls=4, replays=5),
            **bound(nbytes(*fast[:6], dq), (3 * 2 * pairs * d, PEAK_BF16)),
            "exact_bound_ms": bound(nbytes(*exact[:6], dq),
                                    (3 * 2 * pairs * d, PEAK_FP32))["bound_ms"]},
    }
    # the library yardstick on bf16 inputs: forward by graph replays, the
    # backward alone by _sdpa_bwd_ms
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qb, kb, vb, is_causal=True)

    def ours_fwd_bwd():
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        torch.autograd.grad(flash_attention_bf16(*leaves, causal=True), leaves, do)

    # B1's f32 call split: the K/V prep launch, and the kernel on its output
    # (Q still f32: it is scaled and rounded in the kernel); the call on bf16
    # inputs makes no prep launch
    k_b, v_b = kv_to_bf16(k, v)
    q_b = q.to(torch.bfloat16)
    fwd = out["flash_fwd"]
    fwd.update(prep_ms=device_ms(lambda: kv_to_bf16(k, v)),
               kernel_ms=device_ms(lambda: flash_attention_fwd(q, k_b, v_b, causal=True)),
               bf16_in_ms=device_ms(lambda: flash_attention_fwd(q_b, k_b, v_b, causal=True)))
    log(f"[timing] flash_fwd at ({b},{h},{t},{d}) causal, f32 in: call {fwd['ms']:.4f} ms = K/V "
        f"prep launch {fwd['prep_ms']:.4f} ms + kernel {fwd['kernel_ms']:.4f} ms; bf16 in "
        f"(no prep launch) {fwd['bf16_in_ms']:.4f} ms")
    del k_b, v_b, q_b
    sdpa_fwd_ms = device_ms(sdpa_fwd)
    sdpa_bwd_ms = _sdpa_bwd_ms(q, k, v, do)
    ours_fb_ms = queued_ms(ours_fwd_bwd)
    out["flash_fwd"]["library_ms"] = sdpa_fwd_ms
    for name in ("flash_bwd_dkv", "flash_bwd_dq"):
        out[name]["library_ms"] = sdpa_bwd_ms
        out[name]["library_call"] = ("backward of F.scaled_dot_product_attention(is_causal="
                                     "True), bf16: dq, dk, dv together")
    del fast, exact, dk, dv, dq
    call, call_err = _bwd_call_times(q, k, v, o, lse, do)
    out["flash_bwd_dkv"].update(call)
    errs.update({name: max(errs[name], e) for name, e in call_err.items()})
    # B2 + B3 at GQA rep 4, inputs from a generator of their own (the phases
    # after this one draw what they drew before)
    gqa = _bwd_gqa_times(*_qkvdo(torch.Generator(device=dev).manual_seed(9), dev, *BWD_GQA[:3],
                                 BWD_GQA[3], BWD_GQA[3]))
    for name in ("flash_bwd_dkv", "flash_bwd_dq"):
        out[name].update(gqa[name])
    for name, r in out.items():
        log(f"[timing] {name} at ({b},{h},{t},{d}) causal: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
            + (f", exact mode {r['exact_ms']:.4f} ms (bound {r['exact_bound_ms']:.4f} ms "
               "at the fp32 peak)" if "exact_ms" in r else ""))
    pair_ms = out["flash_bwd_dkv"]["ms"] + out["flash_bwd_dq"]["ms"]
    log(f"[timing] sdpa bf16 forward {sdpa_fwd_ms:.4f} ms, backward {sdpa_bwd_ms:.4f} ms (B2 + B3 "
        f"{pair_ms:.4f} ms, ratio {pair_ms / sdpa_bwd_ms:.3f}); flash_attention_bf16 forward + "
        f"backward {_queued_str(ours_fb_ms)}")
    out["flash_fwd"]["fwd_bwd_ms"] = ours_fb_ms
    return out, errs


def _grads(params, tokens, targets, cfg, attention_fn=None):
    """(loss, gradients in param_leaves order) on the tokens' device; with
    `attention_fn`, of lm_loss's formula through transformer_forward's
    attention hook."""
    copy = _to(params, tokens.device)
    leaves = [x.requires_grad_(True) for x in param_leaves(copy)]
    if attention_fn is None:
        loss = lm_loss(copy, tokens, targets, cfg)
    else:
        logits = transformer_forward(copy, tokens, cfg, attention_fn)
        loss = -torch.log_softmax(logits.float(), -1).gather(-1, targets.long()[..., None]).mean()
    return loss.item(), torch.autograd.grad(loss, leaves)


# the wrappers a train step may launch, by attention kind
TRAIN_KERNELS = {"bf16": ("flash_fwd", "flash_bwd_prep", "flash_bwd_dkv", "flash_bwd_dq"),
                 "int8": ("quant_int8", "int8_fwd", "int8_bwd_dkv", "int8_bwd_dq")}
_COUNTED = {"flash_fwd": flash_attention_fwd, "flash_bwd_prep": bwd_prep,
            "flash_bwd_dkv": flash_bwd_dkv,
            "flash_bwd_dq": flash_bwd_dq, "quant_int8": quant_int8,
            "int8_fwd": int8_attention_fwd_from_quantized, "int8_bwd_dkv": int8_bwd_dkv,
            "int8_bwd_dq": int8_bwd_dq, "decode": decode_attention,
            "int8_fused": int8_attention_fwd_fused, "int8_linear": int8_weight_matmul,
            "int4_linear": int4_weight_matmul, "flash_fwd_fp32": flash_attention_fwd_fp32,
            "flash_fwd_fp32_prep": kv_split_tf32,
            "jvp_fwd": attention_jvp_fwd, "jvp_fwd_prep": jvp_fwd_prep,
            "jvp_tangent": attention_tangent_fwd,
            "jvp_bwd_prep": jvp_bwd_prep, "jvp_bwd_dkv": jvp_bwd_dkv, "jvp_bwd_dq": jvp_bwd_dq,
            "paged_decode": paged_decode_attention, "decode4": decode_attention_int4,
            "paged4_decode": paged4_decode_attention, "verify": verify_decode_attention,
            "paged_verify": paged_verify_attention, "verify4": verify_decode_attention_int4,
            "paged4_verify": paged4_verify_attention}


def _launch_counts():
    return {name: fn.launches for name, fn in _COUNTED.items()}


def _reset_counts():
    for fn in _COUNTED.values():
        fn.launches = 0


def _grad_norm(leaves):
    """Global L2 norm of the leaves' gradients (optax.global_norm), on device."""
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(t.grad) for t in leaves]))


def _train(cfg, params, tokens, targets, steps):
    """1 warm-up + `steps` timed steps; returns (losses, step ms, launches per
    step, the global gradient norm of every step). Each step must launch
    each kernel of its attention kind n_layers times and no other."""
    _, step = make_train_step(cfg, params)
    leaves = param_leaves(params)
    losses = [step(tokens, targets)]
    norms = [_grad_norm(leaves)]
    torch.cuda.synchronize()
    _reset_counts()
    per_step, times = [], []
    for _ in range(steps):
        before = _launch_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(step(tokens, targets))
        end.record()
        times.append((start, end))
        per_step.append({k: v - before[k] for k, v in _launch_counts().items()})
        norms.append(_grad_norm(leaves))
    torch.cuda.synchronize()
    losses = torch.stack(losses).tolist()
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"losses not finite and falling: {losses}")
    want = {k: cfg.n_layers if k in TRAIN_KERNELS[cfg.attention] else 0 for k in _COUNTED}
    if any(c != want for c in per_step):
        raise AssertionError(f"kernel launches per step {per_step}, want {want}")
    return losses, [s.elapsed_time(e) for s, e in times], per_step, torch.stack(norms).tolist()


def phase_train(dev, smi, cfg) -> tuple[dict, dict]:
    params = init_transformer(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (TRAIN_BATCH, cfg.max_seq))).to(dev)
    targets = torch.roll(tokens, -1, dims=1)

    # gradient parity on one 256-token sequence: the card vs the CPU plain path
    tok, tgt = tokens[:1, :PARITY_LEN], targets[:1, :PARITY_LEN]
    loss_c, grads_c = _grads(params, tok, tgt, cfg)
    loss_p, grads_p = _grads(_to(params, "cpu"), tok.cpu(), tgt.cpu(), cfg)
    rels = [((g.cpu() - w).norm() / w.norm()).item() for g, w in zip(grads_c, grads_p)]
    loss_rel = abs(loss_c - loss_p) / abs(loss_p)
    log(f"[train] lm_loss on the card vs CPU plain path (1 x {PARITY_LEN} tokens): loss "
        f"{loss_c:.6f} vs {loss_p:.6f} (rel {loss_rel:.2e}, tol {TRAIN_LOSS_REL}); grad rel L2 "
        f"max {max(rels):.3e} median {statistics.median(rels):.3e} over {len(rels)} tensors "
        f"(tol {TRAIN_GRAD_REL_L2})")
    if not (loss_rel <= TRAIN_LOSS_REL and max(rels) <= TRAIN_GRAD_REL_L2):
        raise AssertionError("lm_loss gradients on the card disagree with the CPU plain path")

    torch.cuda.reset_peak_memory_stats(dev)
    losses, step_ms, per_step, norms = _train(cfg, params, tokens, targets, TRAIN_STEPS)
    launches = {k: sum(c[k] for c in per_step) for k in TRAIN_KERNELS[cfg.attention]}
    med = statistics.median(step_ms)
    mem = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"[train] {cfg.attention} attention, {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads, vocab {cfg.vocab_size}, f32 params, {TRAIN_BATCH} x "
        f"{cfg.max_seq} tokens on {smi}: median step {med:.2f} ms (min {min(step_ms):.2f}, "
        f"max {max(step_ms):.2f}; CUDA events), {tokens.numel() / med * 1e3:.0f} tokens/s, "
        f"max_memory_allocated {mem:.2f} GiB, launches {launches} over {TRAIN_STEPS} steps; "
        f"losses {[round(x, 4) for x in losses]}; grad norms {[round(x, 4) for x in norms]}")
    _profile_step(cfg, params, tokens, targets)
    return launches, {"median_ms": med, "max_memory_gib": mem, "grad_norms": norms}


# the CUDA functions of the train step's attention (B1-B3; B4, B5, B7, B8),
# by the launch counter of each
ATTENTION_KERNELS = {"flash_fwd": "flash_fwd_kernel", "flash_bwd_dkv": "dkv_kernel_bf16",
                     "flash_bwd_dq": "dq_kernel_bf16", "quant_int8": "quant_int8_kernel",
                     "int8_fwd": "int8_attn_kernel", "int8_bwd_dkv": "int8_dkv_kernel",
                     "int8_bwd_dq": "int8_dq_kernel"}


def _profile_step(cfg, params, tokens, targets):
    """torch.profiler over one train step: device time by kernel, and busy
    share. Not measured where the profile holds fewer attention launches
    than the counters counted in the step: in a process that has run many
    phases, torch.profiler may lose records (not explained)."""
    from torch.profiler import ProfilerActivity, profile

    _, step = make_train_step(cfg, params)
    step(tokens, targets)
    torch.cuda.synchronize()
    before = _launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(tokens, targets)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    counted = sum(n - before[k] for k, n in _launch_counts().items() if k in ATTENTION_KERNELS)
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    attn = [e for e in events if any(f"{name}{end}" in e.key for name in ATTENTION_KERNELS.values()
                                     for end in "(<")]  # B1-B3 are templates on the head dim
    recorded = sum(e.count for e in attn)
    total_us = sum(e.self_device_time_total for e in events)
    if total_us <= 0 or recorded != counted:
        log(f"[profile] one train step: wall {wall_ms:.2f} ms (profiled); device time not "
            f"measured (torch.profiler recorded {recorded} of the step's {counted} attention "
            f"launches)")
        return
    log(f"[profile] one train step: wall {wall_ms:.2f} ms (profiled), device busy "
        f"{total_us / 1e3:.2f} ms ({total_us / 1e3 / wall_ms:.1%} of wall)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d} calls  "
            f"{e.self_device_time_total / total_us:6.1%}  {e.key[:90]}")
    attn_us = sum(e.self_device_time_total for e in attn)
    log(f"[profile] attention kernels ({cfg.attention}): {attn_us / 1e3:.3f} ms, "
        f"{attn_us / total_us:.1%} of device time")


def phase_train_gqa(dev, cfg) -> dict:
    """Returns the launches of each of the run's attention kernels over its
    timed steps."""
    params = init_transformer(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (GQA_BATCH, cfg.max_seq))).to(dev)
    targets = torch.roll(tokens, -1, dims=1)
    losses, step_ms, per_step, _ = _train(cfg, params, tokens, targets, TRAIN_STEPS)
    launches = {k: sum(c[k] for c in per_step) for k in TRAIN_KERNELS[cfg.attention]}
    # attention is GQA-native (k/v keep their kv heads), so each dK/dV launch
    # that _train counted sums a group of n_heads // n_kv_heads q heads
    rep = cfg.n_heads // cfg.n_kv_heads
    if rep != 2:
        raise AssertionError(f"the dK/dV kernel runs with rep {rep} at the GQA config, want 2")
    log(f"[train_gqa] {cfg.attention} attention, {cfg.n_heads} q / {cfg.n_kv_heads} kv heads, "
        f"d_model {cfg.d_model}, {GQA_BATCH} x {cfg.max_seq} tokens: {TRAIN_STEPS} steps, median "
        f"{statistics.median(step_ms):.2f} ms, dK/dV kernel rep {rep}, launches {launches}; "
        f"losses {[round(x, 4) for x in losses]}")
    return launches


# --------------------------------------------------------------------------
# The int8 (SageAttention) path
# --------------------------------------------------------------------------

INT8_TRAIN_CFG = dataclasses.replace(TRAIN_CFG, attention="int8")
INT8_GQA_CFG = dataclasses.replace(GQA_CFG, attention="int8")

# (b, h, h_kv, t, s, causal, K offset): the training shape; a ragged length
# whose padded K rows, smoothed to -k_mean, set the last K grain's scale (a
# large K mean makes that visible); GQA rep 4, where the Q grain is 512; the
# GQA train phase's attention shape (rep 2, grains 512); the int8 serving
# run's prefill (all 8 prompts in one dispatch, grains 256); an odd cross
# length, non-causal (grains 128 and 256); then the backward's edge shapes: a
# rep that does not divide 64 with t < s, and one token. Then the forward
# kernel's tile edges (128-row blocks, 128-key tiles): t and s off a multiple
# of 128, causal with t < s; rep 3 and rep 5, where 128 / rep is no integer
# (rep 5 also with t > s, non-causal); a single 128-key tile; and rep 3 at
# 170 tokens, whose block at q0 = 126 has two rows with no visible key in its
# second tile (EDGE_CASES, shared with phase 12).
EDGE_CASES = [(1, 8, 8, 200, 330, True, 4.0), (1, 6, 2, 300, 300, True, 4.0),
              (1, 10, 2, 257, 257, True, 0.0), (1, 5, 1, 330, 200, False, 4.0),
              (2, 4, 4, 128, 128, False, 0.0), (1, 3, 1, 170, 170, True, 0.0)]
INT8_CASES = [(4, 16, 16, 2048, 2048, True, 0.0), (2, 16, 16, 1000, 1000, True, 4.0),
              (2, 16, 4, 2048, 2048, True, 0.0),
              (GQA_BATCH, GQA_CFG.n_heads, GQA_CFG.n_kv_heads, GQA_CFG.max_seq, GQA_CFG.max_seq,
               True, 0.0),
              (N_SLOTS, BENCH_CFG.n_heads, BENCH_CFG.n_kv_heads, PROMPT_LEN, PROMPT_LEN, True, 0.0),
              (1, 4, 2, 77, 201, False, 4.0), (2, 6, 2, 33, 130, True, 4.0),
              (1, 3, 1, 1, 1, True, 0.0), *EDGE_CASES]


def _check_int8(q, k, v, do, causal, label, q_offset=0, k_offset=0) -> tuple[dict, dict]:
    """B4 (byte for byte), B5, B7 and B8 against their plain versions on one
    case (causal on global positions q_offset + i, k_offset + j), raising
    outside the tolerances; each kernel called twice for the same bits.
    Returns (each kernel's max|diff|, dq's, dk's and dv's max|diff| /
    max|plain|)."""
    k_mean = k.mean(dim=-2, keepdim=True)
    res = quantize_qkv(q, k, v, k_sub=k_mean)
    res2 = quantize_qkv(q, k, v, k_sub=k_mean)
    torch.cuda.synchronize()
    res_p = quantize_qkv_plain(q, k, v, k_sub=k_mean)
    if not all(torch.equal(a, b) and torch.equal(a, c) for pair, pair_p, pair2
               in zip(res, res_p, res2) for a, b, c in zip(pair, pair_p, pair2)):
        raise AssertionError(f"quant_int8 is not byte-equal to its plain version (or to its "
                             f"second call) at {label}")
    del res2
    dims = (*q.shape[:3], k.shape[2], q.shape[3])
    offsets = {"q_offset": q_offset, "k_offset": k_offset}
    o, lse = int8_attention_fwd_from_quantized(res, dims, causal=causal, **offsets)
    o2, lse2 = int8_attention_fwd_from_quantized(res, dims, causal=causal, **offsets)
    torch.cuda.synchronize()
    if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
        raise AssertionError(f"int8_fwd gives other bits on a second call at {label}")
    del o2, lse2
    o_p, lse_p = int8_attention_fwd_from_quantized_plain(res, dims, causal=causal, **offsets)
    err = {"quant_int8": 0.0, "int8_fwd": (o - o_p).abs().max().item()}
    seen = torch.isfinite(lse_p)
    err_l = (lse[seen] - lse_p[seen]).abs().max().item() if seen.any() else 0.0
    if not torch.equal(seen, torch.isfinite(lse)):
        raise AssertionError(f"int8_fwd's rows that see no key differ from the plain version's "
                             f"at {label}")
    del o_p, lse_p
    ops = int8_bwd_operands(res, k_mean, o, lse, do, dims, causal=causal, **offsets)
    dk, dv = int8_bwd_dkv(ops)
    dq = int8_bwd_dq(ops)
    again = (*int8_bwd_dkv(ops), int8_bwd_dq(ops))
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip((dk, dv, dq), again)):
        raise AssertionError(f"int8 backward kernels give other bits on a second call at {label}")
    del again
    dk_p, dv_p = int8_bwd_dkv_plain(ops)
    dq_p = int8_bwd_dq_plain(ops)
    rel = {}
    for name, got, want in (("dq", dq, dq_p), ("dk", dk, dk_p), ("dv", dv, dv_p)):
        if not torch.isfinite(got).all():
            raise AssertionError(f"int8 backward {name} is not finite at {label}")
        diff = (got - want).abs().max().item()
        rel[name] = diff / want.abs().max().item()
        kernel = "int8_bwd_dq" if name == "dq" else "int8_bwd_dkv"
        err[kernel] = max(err.get(kernel, 0.0), diff)
    log(f"[int8] {label}: quant_int8 byte-equal; int8_fwd max|dO|={err['int8_fwd']:.3e} (tol "
        f"{FLASH_O_TOL}) max|dlse|={err_l:.3e} (tol {FLASH_LSE_TOL}); backward max|diff|/"
        f"max|plain| dq {rel['dq']:.3e} dk {rel['dk']:.3e} dv {rel['dv']:.3e} (tol {INT8_BWD_TOL}), "
        f"second call bit-equal")
    if not (err["int8_fwd"] <= FLASH_O_TOL and err_l <= FLASH_LSE_TOL):
        raise AssertionError("int8_fwd kernel disagrees with its plain version")
    if max(rel.values()) > INT8_BWD_TOL:
        raise AssertionError("int8 backward kernels disagree with their plain versions")
    if k_mean.abs().max().item() > 1.0:
        _check_k_mean_term(ops, label)
    return err, rel


def _check_k_mean_term(ops, label) -> None:
    """B8's K-smoothing term rowsum(dS)·k_mean on its own. With D = rowsum(dO·O)
    the rowsum of dS cancels to ~0, so the term hides in the dQ check above;
    halving D makes it rowsum(P·dP)/2·sm_scale per row. B8 must then still
    match its plain version, and the term must be large enough that a kernel
    without it would not."""
    ops = ops._replace(di=ops.di * 0.5)
    dq = int8_bwd_dq(ops)
    torch.cuda.synchronize()
    dq_p = int8_bwd_dq_plain(ops)
    term = int8_bwd_dq_plain(ops._replace(k_mean=torch.zeros_like(ops.k_mean))) - dq_p
    scale = dq_p.abs().max().item()
    rel, rel_term = (dq - dq_p).abs().max().item() / scale, term.abs().max().item() / scale
    log(f"[int8] {label}, D halved: dq max|diff|/max|plain| {rel:.3e} (tol {INT8_BWD_TOL}); "
        f"k_mean term max|term|/max|plain| {rel_term:.3e} (want > {10 * INT8_BWD_TOL})")
    if not (rel <= INT8_BWD_TOL and rel_term > 10 * INT8_BWD_TOL):
        raise AssertionError("int8_bwd_dq's K-smoothing term disagrees with its plain version")


# B4's grains with a partial last grain: (grain, t) at 2 x 4 heads
QUANT_GRAINS = [(128, 3 * 128 - 37), (256, 3 * 256 - 37), (512, 3 * 512 - 37),
                (1024, 2 * 1024 - 37)]


def _check_quant(gen, dev, d=64) -> None:
    """B4 byte-equal to its plain version (payloads and scales) on [b, h, t,
    d] f32 views of [b, t, h, d] tensors (through `quant_int8`) and on bf16
    (through `quant_int8_uncounted`, as B6 launches it), Q, K (with its
    smoothing shift) and V of one launch at each of QUANT_GRAINS, then one
    launch of three jobs at three grains."""
    cases = []
    for grain, t in QUANT_GRAINS:
        pad = -(-t // grain) * grain
        q, k, v = _strided(*(torch.randn((2, 4, t, d), generator=gen, device=dev)
                             for _ in range(3)))
        sub = k.mean(-2).reshape(8, d).contiguous()
        cases.append((f"grain {grain}, t {t}",
                      [QuantJob(q, pad, grain), QuantJob(k, pad, grain, sub),
                       QuantJob(v, pad, grain)]))
    x = _strided(torch.randn((2, 4, 1500, d), generator=gen, device=dev))[0]
    cases.append(("grains 1024, 128, 512 in one launch, t 1500",
                  [QuantJob(x, 2048, 1024), QuantJob(x, 1536, 128, x.mean(-2).reshape(8, d)),
                   QuantJob(x, 1536, 512)]))
    for label, jobs in cases:
        for dtype, fn in ((torch.float32, quant_int8), (torch.bfloat16, quant_int8_uncounted)):
            typed = [j._replace(x=j.x.to(dtype)) for j in jobs]  # .to keeps the strides
            assert not typed[0].x.is_contiguous()
            got = fn(typed)
            torch.cuda.synchronize()
            want = quant_int8_plain(typed)
            if not all(torch.equal(a, b) for g, w in zip(got, want) for a, b in zip(g, w)):
                raise AssertionError(f"quant_int8 is not byte-equal to its plain version on "
                                     f"{dtype} views, {label}")
    log(f"[int8] quant_int8 byte-equal to its plain version on f32 and bf16 [b, h, t, {d}] views "
        f"of [b, t, h, {d}] tensors: " + "; ".join(label for label, _ in cases))


def phase_int8_kernels(dev, gen) -> dict:
    _check_quant(gen, dev)
    errs = []
    for b, h, h_kv, t, s, causal, shift in INT8_CASES:
        q, k, v, do = _qkvdo(gen, dev, b, h, h_kv, t, s)
        errs.append(_check_int8(q, k + shift, v, do, causal, f"b={b} h={h} h_kv={h_kv} t={t} "
                                f"s={s} causal={causal} K mean {shift}")[0])
    return _worst(*errs)


# B7 and B8 are also timed at GQA rep 4: (b, h, h_kv, t), causal
INT8_BWD_GQA = (2, 16, 4, 2048)


def queued_ms(fn, calls: int = 10, sleep_cycles: int = 400_000_000) -> float | None:
    """Device time of one `fn()` call: CUDA events around `calls` eager
    calls, after one warm-up call, queued behind a torch.cuda._sleep of
    `sleep_cycles` (about 0.2 s) so that the card starts the first call only
    once the host has queued the last. For work whose host dispatch
    outruns its device time in an eager loop (the port's autograd calls),
    which then does not show in the span. None when the card reached the
    first event before the host had queued the last call (a call waited on
    the card, or the sleep was too short): the span would hold host time."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep_cycles)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    queued = not start.query()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls if queued else None


def _queued_str(ms: float | None) -> str:
    return (f"{ms:.4f} ms (CUDA events over calls queued behind a device sleep)" if ms is not None
            else "not measured (the card caught up with the host's queue)")


def device_kernels(fn) -> dict:
    """{CUDA kernel name: launches} of one `fn()` call, by torch.profiler,
    after one warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages() if e.device_type.name == "CUDA"}


def _sdpa_bwd_ms(q, k, v, do, dtype=torch.bfloat16, backends=None, **replays) -> float:
    """SDPA's backward alone on `dtype` copies, causal, K/V repeated over the
    GQA group: (forward + backward) - forward, each by CUDA-graph replays
    (`device_ms` with `replays`) after eager warm-up calls (phases 7 and 8;
    phase 30 on f32 with `backends`, SDPA's fused backends that take it)."""
    from torch.nn.attention import sdpa_kernel

    rep = q.shape[1] // k.shape[1]
    qb, kb, vb = (x.to(dtype).requires_grad_(True)
                  for x in (q, k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)))
    dob = do.to(dtype)

    def pick():  # SDPA's own choice unless `backends` is given
        return sdpa_kernel(backends) if backends else contextlib.nullcontext()

    def fwd():
        with torch.no_grad(), pick():
            return F.scaled_dot_product_attention(qb, kb, vb, is_causal=True)

    def fwd_bwd():
        with pick():
            torch.autograd.grad(F.scaled_dot_product_attention(qb, kb, vb, is_causal=True),
                                (qb, kb, vb), dob)

    for _ in range(3):
        fwd_bwd()
    return device_ms(fwd_bwd, **replays) - device_ms(fwd, **replays)


def _int8_bwd_times(q, k, v, do, sdpa_bwd_ms=None) -> tuple[dict, object]:
    """B7 and B8 on q/do [b, h, t, d], k/v [b, h_kv, t, d], causal: device
    time, bound and TFLOP/s of each, beside SDPA's bf16 backward (measured
    here unless given). Returns (the times, the kernels' operands)."""
    (b, h, t, d), h_kv = q.shape, k.shape[1]
    k_mean = k.mean(dim=-2, keepdim=True)
    res = quantize_qkv(q, k, v, k_sub=k_mean)
    dims = (b, h, t, t, d)
    o, lse = int8_attention_fwd_from_quantized(res, dims, causal=True)
    ops = int8_bwd_operands(res, k_mean, o, lse, do, dims, causal=True)
    dk, dv = int8_bwd_dkv(ops)
    dq = int8_bwd_dq(ops)
    prod = 2 * b * h * visible_pairs(t, t, True) * d  # one product over the visible pairs
    payload = nbytes(*(x for pair in res for x in pair))
    rows_in = nbytes(ops.do, ops.lse, ops.di)
    lib_ms = _sdpa_bwd_ms(q, k, v, do) if sdpa_bwd_ms is None else sdpa_bwd_ms
    out = {
        "int8_bwd_dkv": {"ms": device_ms(lambda: int8_bwd_dkv(ops)), "products": 4,
                         **bound(payload + rows_in + nbytes(dk, dv), (prod, PEAK_INT8),
                                 (3 * prod, PEAK_BF16))},
        "int8_bwd_dq": {"ms": device_ms(lambda: int8_bwd_dq(ops)), "products": 3,
                        **bound(payload + rows_in + nbytes(ops.k_mean, dq), (prod, PEAK_INT8),
                                (2 * prod, PEAK_BF16))},
    }
    pair_ms = out["int8_bwd_dkv"]["ms"] + out["int8_bwd_dq"]["ms"]
    shape = f"({b},{h}q/{h_kv}kv,{t},{d})" if h != h_kv else f"({b},{h},{t},{d})"
    for name, r in out.items():
        r["tflops"] = r.pop("products") * prod / r["ms"] / 1e9
        r["library_ms"] = lib_ms
        log(f"[timing] {name} at {shape} causal: kernel {r['ms']:.4f} ms ({r['tflops']:.1f} "
            f"TFLOP/s, bf16-equivalent products), bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    log(f"[timing] int8 backward at {shape} causal: B7 + B8 {pair_ms:.4f} ms, sdpa bf16 backward "
        f"{lib_ms:.4f} ms, ratio {pair_ms / lib_ms:.3f}")
    return out, ops


def phase_int8_timing(dev, gen, sdpa: dict, d: int = 64, census: bool = True) -> dict:
    """Device time per call of B4, B5, B7 and B8 at the training shape at
    head dim d (BASELINE config 4's shape at 128), causal, beside their
    plain versions and their bounds; B7 and B8 also at GQA rep 4. No single
    PyTorch call computes int8 attention; SDPA's bf16 times at the same head
    dim ride along for scale (its backward is B7 + B8's library_ms). B4 on
    the model's views must launch once and copy nothing; with `census`, the
    profile that shows it must not be empty."""
    b, h, t = TRAIN_BATCH, 16, TRAIN_CFG.max_seq
    q, k, v, do = _qkvdo(gen, dev, b, h, h, t, t, d)
    k_mean = k.mean(dim=-2, keepdim=True)
    res = quantize_qkv(q, k, v, k_sub=k_mean)
    dims = (b, h, t, t, d)
    o, lse = int8_attention_fwd_from_quantized(res, dims, causal=True)
    prod = 2 * b * h * visible_pairs(t, t, True) * d  # one product over the visible pairs
    payload = nbytes(*(x for pair in res for x in pair))

    def plain_ms(fn):
        return device_ms(fn, calls=4, replays=5)

    views = _strided(q, k, v)
    bf16_jobs = _qkv_jobs(*(x.to(torch.bfloat16) for x in (q, k, v)), k_mean, to_f32=False)
    bf16_bytes = nbytes(*(j.x for j in bf16_jobs), k_mean) + payload
    out = {
        "quant_int8": {
            "ms": device_ms(lambda: quantize_qkv(q, k, v, k_sub=k_mean)),
            "views_ms": device_ms(lambda: quantize_qkv(*views, k_sub=k_mean)),
            "bf16_ms": device_ms(lambda: quant_int8_uncounted(bf16_jobs)),
            "bf16_bound_ms": bound(bf16_bytes, (2 * (q.numel() + 2 * k.numel()),
                                                PEAK_FP32))["bound_ms"],
            "plain_ms": plain_ms(lambda: quantize_qkv_plain(q, k, v, k_sub=k_mean)),
            **bound(nbytes(q, k, v, k_mean) + payload, (2 * (q.numel() + 2 * k.numel()), PEAK_FP32))},
        "int8_fwd": {
            "ms": device_ms(lambda: int8_attention_fwd_from_quantized(res, dims, causal=True)),
            "plain_ms": plain_ms(lambda: int8_attention_fwd_from_quantized_plain(res, dims, True)),
            **bound(payload + nbytes(o, lse), (prod, PEAK_INT8), (prod, PEAK_BF16)),
            "sdpa_bf16_ms": sdpa["fwd"]},
    }
    for name, r in out.items():
        r["library_ms"] = None
        log(f"[timing] {name} at ({b},{h},{t},{d}) causal: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    r = out["quant_int8"]
    # on the model's views the kernel reads Q, K and V in place: one launch, no
    # copy (B4's jobs are the caller's tensors, and the profile holds one B4
    # launch alone). In a process that has run the phases before 30,
    # torch.profiler may record nothing for so small a profile (not
    # explained): `census` makes an empty profile fail, as in phase 8 and in
    # `python3 chip_smoke.py head128`, where it records
    before = quant_int8.launches
    launched = device_kernels(lambda: quantize_qkv(*views, k_sub=k_mean))
    in_place = all(j.x.data_ptr() == x.data_ptr() for j, x in zip(_qkv_jobs(*views, k_mean), views))
    log(f"[int8] quantize_qkv on the model's f32 views launches {launched or 'not recorded'}; "
        f"B4 counted {quant_int8.launches - before} in 2 calls; jobs on the caller's storage: "
        f"{in_place}")
    one_b4 = (len(launched) == 1 and "quant_int8_kernel" in next(iter(launched))
              and sum(launched.values()) == 1)
    if not in_place or quant_int8.launches - before != 2 or (not one_b4 and (launched or census)):
        raise AssertionError(f"quantize_qkv on [b, h, t, {d}] views launched {launched}, want "
                             "one B4 launch and no copy")
    r["ms_of"] = (f"quantize_qkv on contiguous f32; views_ms on the model's [b, h, t, {d}] views "
                  f"of [b, t, h, {d}] f32 tensors; bf16_ms one launch on bf16 views, as B6's")
    log(f"[timing] quant_int8 on the model's f32 views {r['views_ms']:.4f} ms; on bf16 "
        f"{r['bf16_ms']:.4f} ms (bound {r['bf16_bound_ms']:.4f} ms)")
    bwd, ops = _int8_bwd_times(q, k, v, do, sdpa["bwd"])
    bwd["int8_bwd_dkv"]["plain_ms"] = plain_ms(lambda: int8_bwd_dkv_plain(ops))
    bwd["int8_bwd_dq"]["plain_ms"] = plain_ms(lambda: int8_bwd_dq_plain(ops))
    del ops
    # the GQA shape's inputs from a generator of their own (the phases after
    # this one draw what they drew before it timed a second shape)
    gqa, _ = _int8_bwd_times(*_qkvdo(torch.Generator(device=dev).manual_seed(8), dev,
                                     *INT8_BWD_GQA[:3], INT8_BWD_GQA[3], INT8_BWD_GQA[3], d))
    for name, r in bwd.items():
        r["library_call"] = ("backward of F.scaled_dot_product_attention(is_causal=True), bf16: "
                             "dq, dk, dv together")
        r.update({f"gqa_{key}": gqa[name][key] for key in ("ms", "bound_ms", "tflops",
                                                             "library_ms")})
        r["gqa_shape"] = f"(2, 16 q / 4 kv heads, 2048, {d}) causal"
        log(f"[timing] {name} plain {r['plain_ms']:.4f} ms")
    out.update(bwd)

    def fwd_bwd():
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        torch.autograd.grad(sage_attention_int8(*leaves, causal=True), leaves, do)

    fb_ms = queued_ms(fwd_bwd)
    log(f"[timing] sage_attention_int8 forward + backward {_queued_str(fb_ms)}; sdpa bf16 forward "
        f"{sdpa['fwd']:.4f} ms, backward {sdpa['bwd']:.4f} ms")
    out["int8_fwd"]["fwd_bwd_ms"] = fb_ms
    return out


def phase_int8_oracle(dev, gen, d: int = 64) -> None:
    """sage_attention_int8 at the training shape (BASELINE config 4; head
    dim d) against the fp32 oracle, by the JAX package's own criteria
    (tests/test_int8_attention.py)."""
    b, h, t = TRAIN_BATCH, 16, TRAIN_CFG.max_seq
    q, k, v, do = _qkvdo(gen, dev, b, h, h, t, t, d)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o = sage_attention_int8(*leaves, causal=True)
    got = torch.autograd.grad(o, leaves, do)
    fwd = mismatch_report("int8 fwd", o.detach(), reference_attention(q, k, v, causal=True),
                          INT8_ATOL)
    want = reference_attention_vjp(q, k, v, do, causal=True)
    rels = {n: ((g - w).norm() / w.norm()).item() for n, g, w in zip(("dq", "dk", "dv"), got, want)}
    del got, want
    # tiny magnitudes: the dequant scale c is ~1e-9, and the mask sentinel
    # 30000 / -c must still keep the future out
    qs, ks = q * 0.01, k * 0.01
    tiny = mismatch_report("tiny-scale causal int8", int8_attention_fwd(qs, ks, v, causal=True)[0],
                           reference_attention(qs, ks, v, causal=True), INT8_ATOL)
    # a large common K component: K-smoothing must beat the raw int8 path
    k6 = k + 6.0
    want6 = reference_attention(q, k6, v)
    mse_s = (sage_attention_int8(q, k6, v) - want6).square().mean().item()
    mse_r = (int8_attention_fwd(q, k6, v)[0] - want6).square().mean().item()
    log(f"[int8] sage_attention_int8 vs fp32 oracle ({b},{h},{t},{d}) causal: {fwd}; grad rel L2 "
        + ", ".join(f"{n} {r:.3e}" for n, r in rels.items())
        + f" (tol {INT8_GRAD_REL_L2}); {tiny}; K + 6 non-causal: MSE smoothed {mse_s:.3e} vs raw "
        f"{mse_r:.3e}")
    if not (fwd.mismatch_rate <= INT8_FWD_RATE and tiny.mismatch_rate <= INT8_FWD_RATE
            and max(rels.values()) <= INT8_GRAD_REL_L2 and mse_s < mse_r):
        raise AssertionError("sage_attention_int8 outside the JAX package's oracle criteria")


# --------------------------------------------------------------------------
# Int8 inference (B6) and weight-only quantization (B17, B18)
# --------------------------------------------------------------------------

# (b, h, h_kv, t, s, causal, K offset, dtype): BASELINE config 3's shape in
# bf16 (the serving dtype) and f32; a ragged length whose padded K rows,
# smoothed to -k_mean, set the last K grain's scale; GQA rep 4 (Q grain 512);
# an odd cross length, non-causal; rep 3 with t < s; one token; then phase
# 8's tile edges (EDGE_CASES), in bf16 and f32 by turns.
FUSED_CASES = [(4, 16, 16, 2048, 2048, True, 0.0, torch.bfloat16),
               (4, 16, 16, 2048, 2048, True, 0.0, torch.float32),
               (2, 16, 16, 1000, 1000, True, 4.0, torch.bfloat16),
               (4, 16, 4, 1024, 1024, True, 0.0, torch.bfloat16),
               (1, 4, 2, 77, 201, False, 4.0, torch.float32),
               (2, 6, 2, 33, 130, True, 4.0, torch.float32),
               (1, 3, 1, 1, 1, True, 0.0, torch.float32),
               *((*case, (torch.bfloat16, torch.float32)[i % 2])
                 for i, case in enumerate(EDGE_CASES))]
CONFIG3_SEQS = (2048, 4096, 8192)


def _qkv(gen, dev, b, h, h_kv, t, s, dtype=torch.float32, shift=0.0, d=64):
    q = torch.randn((b, h, t, d), generator=gen, device=dev)
    k = torch.randn((b, h_kv, s, d), generator=gen, device=dev) + shift
    v = torch.randn((b, h_kv, s, d), generator=gen, device=dev)
    return q.to(dtype), k.to(dtype), v.to(dtype)


def _check_fused(q, k, v, causal, label, plain=True) -> float:
    """B6 on one case, with the K shift the inference entry point takes (the
    K mean in k's dtype): against B4 then B5 on the same inputs (lse equal,
    O within FUSED_O_TOL) and, where it fits in memory, against its plain
    version (B5's tolerances). Returns max|dO| against the plain version."""
    k_sub = k.float().mean(-2, keepdim=True).to(k.dtype)
    o, lse = int8_attention_fwd_fused(q, k, v, causal=causal, k_sub=k_sub)
    res = quantize_qkv(q, k, v, k_sub=k_sub)
    o_m, lse_m = int8_attention_fwd_from_quantized(res, (*q.shape[:3], k.shape[2], q.shape[3]),
                                                   causal)
    torch.cuda.synchronize()
    d_o, d_l = (o - o_m).abs().max().item(), (lse - lse_m).abs().max().item()
    del res, o_m, lse_m
    msg = (f"[int8_fused] {label}: vs B4 -> B5 max|dO|={d_o:.3e} (tol {FUSED_O_TOL}) "
           f"max|dlse|={d_l:.3e} (want 0)")
    if not (torch.isfinite(o).all() and d_o <= FUSED_O_TOL and d_l == 0.0):
        raise AssertionError(msg + ": B6 disagrees with B4 then B5")
    err = 0.0
    if plain:
        o_p, lse_p = int8_attention_fwd_fused_plain(q, k, v, causal, k_sub=k_sub)
        err, err_l = (o - o_p).abs().max().item(), (lse - lse_p).abs().max().item()
        msg += (f"; vs plain max|dO|={err:.3e} (tol {FLASH_O_TOL}) max|dlse|={err_l:.3e} "
                f"(tol {FLASH_LSE_TOL})")
        if not (err <= FLASH_O_TOL and err_l <= FLASH_LSE_TOL):
            raise AssertionError(msg + ": B6 disagrees with its plain version")
    log(msg)
    return err


def phase_int8_fused(dev, gen) -> float:
    """Phase 12. Returns B6's worst max|dO| against its plain version."""
    worst = 0.0
    for b, h, h_kv, t, s, causal, shift, dtype in FUSED_CASES:
        q, k, v = _qkv(gen, dev, b, h, h_kv, t, s, dtype, shift)
        worst = max(worst, _check_fused(q, k, v, causal, f"b={b} h={h} h_kv={h_kv} t={t} s={s} "
                                        f"causal={causal} K mean {shift} {dtype}"))
    # the plain version of (4,16,8192,64) would need tens of GB: B4 -> B5 only
    for t in CONFIG3_SEQS[1:]:
        q, k, v = _qkv(gen, dev, 4, 16, 16, t, t, torch.bfloat16)
        _check_fused(q, k, v, True, f"(4,16,{t},64) causal bf16", plain=False)
    return worst


def _oracle_by_batch(q, k, v, causal):
    """reference_attention one batch element at a time (its f32 scores at
    (16, 8192, 8192) are 4 GiB an element)."""
    return torch.cat([reference_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1], causal)
                      for i in range(q.shape[0])])


def phase_int8_infer_oracle(dev, gen, d: int = 64, shapes=((16, CONFIG3_SEQS[0]),)) -> None:
    """Phase 13 (and phase 30 at d = 128): sage_attention_int8_inference
    against the fp32 oracle with bench.py's gate (f32 inputs), causal at 4 x
    16 q heads and each (h_kv, t) of `shapes`, and non-causal with a common
    K offset of 8 at the first."""
    reps = []
    for i, (h_kv, t) in enumerate(shapes):
        q, k, v = _qkv(gen, dev, 4, 16, h_kv, t, t, d=d)
        reps.append(mismatch_report(f"int8 inference fwd (4,16q/{h_kv}kv,{t},{d}) causal",
                                    sage_attention_int8_inference(q, k, v, True),
                                    _oracle_by_batch(q, k, v, True), INT8_ATOL))
        if i == 0:
            k8 = k + 8.0
            reps.append(mismatch_report(f"int8 inference fwd (4,16q/{h_kv}kv,{t},{d}), K + 8",
                                        sage_attention_int8_inference(q, k8, v),
                                        _oracle_by_batch(q, k8, v, False), INT8_ATOL))
            del k8
        del q, k, v
    log(f"[int8_fused] sage_attention_int8_inference vs fp32 oracle: " + "; ".join(map(str, reps))
        + f" (gate: rate <= {INT8_FWD_RATE} at atol {INT8_ATOL})")
    if max(r.mismatch_rate for r in reps) > INT8_FWD_RATE:
        raise AssertionError(f"sage_attention_int8_inference at head dim {d} outside bench.py's "
                             "gate")


def _b1_bound_ms(q, k, v, pairs) -> float:
    """B1's bound on bf16 inputs: both products in bf16 over the visible
    pairs, against reading q, k, v and writing O and lse in f32."""
    out_bytes = 4 * (q.numel() + q.numel() // q.shape[-1])
    return bound(nbytes(q, k, v) + out_bytes, (2 * 2 * pairs * q.shape[-1], PEAK_BF16))["bound_ms"]


def phase_int8_infer_timing(dev, gen, d: int = 64) -> tuple[dict, dict]:
    """Phase 14, BASELINE config 3 (at head dim d). The path run:
    sage_attention_int8_inference once at each sequence length on bf16
    inputs, counts from 0. Then device time per call of B6 (with the K shift
    precomputed), SDPA bf16, B4 -> B5 (`int8_attention_fwd`, which also
    casts to f32) and B1 on the same inputs. Returns (B6's numbers at
    (4,16,2048,d), the path's launches)."""
    inputs = {t: _qkv(gen, dev, 4, 16, 16, t, t, torch.bfloat16, d=d) for t in CONFIG3_SEQS}
    _reset_counts()
    for t, (q, k, v) in inputs.items():
        o = sage_attention_int8_inference(q, k, v, causal=True)
        if o.shape != q.shape or not torch.isfinite(o).all():
            raise AssertionError(f"sage_attention_int8_inference at {t} tokens: not finite")
    launches = _launch_counts()
    if {k for k, n in launches.items() if n} != {"int8_fused"}:
        raise AssertionError(f"the inference path launched {launches}, want int8_fused only")

    def plain_ms(fn):
        return device_ms(fn, calls=4, replays=5)

    rows, out = {}, None
    for t, (q, k, v) in inputs.items():
        k_sub = k.float().mean(-2, keepdim=True).to(k.dtype)
        o, lse = int8_attention_fwd_fused(q, k, v, causal=True, k_sub=k_sub)
        pairs = 4 * 16 * visible_pairs(t, t, True)
        flops = 4 * 4 * 16 * t * t * d * 0.5  # bench.py's count
        dims, jobs = _fused_launch_args(q, k, v, k_sub)
        scratch = quant_int8_uncounted(jobs)
        r = {"ms": device_ms(lambda: int8_attention_fwd_fused(q, k, v, True, k_sub=k_sub)),
             "quantize_ms": device_ms(lambda: quant_int8_uncounted(jobs)),
             "mainloop_ms": device_ms(lambda: _attend(scratch, dims, True, None)),
             "entry_ms": device_ms(lambda: sage_attention_int8_inference(q, k, v, True)),
             "sdpa_ms": device_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)),
             "b4_b5_ms": device_ms(lambda: int8_attention_fwd(q, k, v, True, k_sub=k_sub)),
             "b1_ms": device_ms(lambda: flash_attention_fwd(q, k, v, causal=True)),
             "b1_bound_ms": _b1_bound_ms(q, k, v, pairs),
             **bound(nbytes(q, k, v, k_sub, o, lse), (2 * pairs * d, PEAK_INT8),
                     (2 * pairs * d, PEAK_BF16), (2 * (q.numel() + 2 * k.numel()), PEAK_FP32))}
        r["tflops"] = {name: flops / (r[key] * 1e-3) / 1e12 for name, key in (
            ("int8_fused", "ms"), ("sdpa", "sdpa_ms"), ("b4_b5", "b4_b5_ms"), ("b1", "b1_ms"))}
        if t == CONFIG3_SEQS[0]:
            r["plain_ms"] = plain_ms(lambda: int8_attention_fwd_fused_plain(q, k, v, True,
                                                                           k_sub=k_sub))
            out = r
        rows[t] = r
        del scratch
        log(f"[timing] config 3 (4,16,{t},{d}) causal bf16: B6 {r['ms']:.4f} ms "
            f"({r['tflops']['int8_fused']:.1f} TFLOP/s; Q/K/V quantize launch "
            f"{r['quantize_ms']:.4f} ms + mainloop {r['mainloop_ms']:.4f} ms; entry point "
            f"{r['entry_ms']:.4f} ms), "
            f"sdpa {r['sdpa_ms']:.4f} ms ({r['tflops']['sdpa']:.1f}), B4 -> B5 "
            f"{r['b4_b5_ms']:.4f} ms ({r['tflops']['b4_b5']:.1f}), B1 {r['b1_ms']:.4f} ms "
            f"({r['tflops']['b1']:.1f}); bound {r['bound_ms']:.4f} ms ({r['bound_by']}), B1's "
            f"{r['b1_bound_ms']:.4f} ms"
            + (f"; B6 plain {r['plain_ms']:.4f} ms" if "plain_ms" in r else ""))
    del inputs
    # the GQA A/B shape (bench.py:250)
    t = CONFIG3_SEQS[1]
    q, k, v = _qkv(gen, dev, 4, 16, 4, t, t, torch.bfloat16, d=d)
    k_sub = k.float().mean(-2, keepdim=True).to(k.dtype)
    gqa = {"ms": device_ms(lambda: int8_attention_fwd_fused(q, k, v, True, k_sub=k_sub)),
           "sdpa_ms": device_ms(lambda: F.scaled_dot_product_attention(
               q, k, v, is_causal=True, enable_gqa=True)),
           "b4_b5_ms": device_ms(lambda: int8_attention_fwd(q, k, v, True, k_sub=k_sub)),
           "b1_ms": device_ms(lambda: flash_attention_fwd(q, k, v, causal=True)),
           "b1_bound_ms": _b1_bound_ms(q, k, v, 4 * 16 * visible_pairs(t, t, True))}
    log(f"[timing] GQA (4,16q/4kv,{t},{d}) causal bf16: B6 {gqa['ms']:.4f} ms, sdpa "
        f"{gqa['sdpa_ms']:.4f} ms, B4 -> B5 {gqa['b4_b5_ms']:.4f} ms, B1 {gqa['b1_ms']:.4f} ms "
        f"(bound {gqa['b1_bound_ms']:.4f} ms)")
    out.update(library_ms=out["sdpa_ms"],
               library_call="F.scaled_dot_product_attention(is_causal=True), bf16",
               by_seq={str(t): {k: v for k, v in r.items() if k != "bound_by"}
                       for t, r in rows.items()},
               gqa=gqa)
    return out, launches


# (m, k, n): decode (the engine's 8 slots), a spec verify pass (8 slots x
# SPEC_K + 1 tokens) and prefill (8 x 256 tokens) rows against the bench
# widths' weights; then one rank of phase 26's mesh: decode (MESH_ROWS
# slots) and one 256-token prompt's prefill rows against its column shards
# (wq, wk, wv: 1024 x 512; w1: 1024 x 2048), contraction shards (wo: 512 x
# 1024; w2: 2048 x 1024) and the replicated unembed, and a prefill's last
# row through the unembed; and an odd shape
_D, _F, _MODEL = BENCH_CFG.d_model, BENCH_CFG.mlp_dim, MESH_SHAPE[1]
WEIGHT_SHAPES = [(m, k, n) for m in (N_SLOTS, N_SLOTS * (SPEC_K + 1), N_SLOTS * PROMPT_LEN)
                 for k, n in ((1024, 1024), (1024, 4096), (4096, 1024), (1024, 8192))] + [
    (m, k, n) for m in (MESH_ROWS, PROMPT_LEN)
    for k, n in ((_D, _D // _MODEL), (_D // _MODEL, _D), (_D, _F // _MODEL), (_F // _MODEL, _D),
                 (_D, BENCH_CFG.vocab_size))] + [(1, _D, BENCH_CFG.vocab_size)]
WEIGHT_ODD = (5, 1000, 300)
WEIGHT_HEADLINE = (N_SLOTS, 1024, 4096)  # decode through w1


def _check_weight(name, fn, plain, label) -> float:
    """A weight kernel against its plain version: the f32 output within
    WEIGHT_F32_REL of max|plain|, the bf16 output within one bf16 ulp plus
    that; a second call on the same inputs must give the same bits (the
    cluster's k-split sum runs in a fixed order, with no atomics). Returns
    the f32 output's max|diff|."""
    got, want = fn(torch.float32), plain(torch.float32)
    got_b, want_b = fn(None).float(), plain(None).float()
    again, again_b = fn(torch.float32), fn(None).float()
    torch.cuda.synchronize()
    if not (torch.equal(got, again) and torch.equal(got_b, again_b)):
        raise AssertionError(f"{name} gave other bits on a second call at {label}")
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    ulp = torch.exp2(torch.floor(torch.log2(want_b.abs().clamp_min(1e-30))) - 7)
    over = ((got_b - want_b).abs() - ulp).max().item()
    bf16_ok = over <= WEIGHT_F32_REL * scale
    log(f"[{name}] {label}: f32 out max|diff|/max|plain| {err / scale:.3e} (tol {WEIGHT_F32_REL}); "
        f"bf16 out max(|diff| - ulp)/max|plain| {max(over, 0.0) / scale:.3e} "
        f"(tol {WEIGHT_F32_REL})")
    rel = err / scale
    if not (torch.isfinite(got).all() and rel <= WEIGHT_F32_REL and bf16_ok):
        raise AssertionError(f"{name} disagrees with its plain version at {label}")
    return err


def phase_weight_kernels(dev, gen) -> dict:
    """Phase 15: B17 and B18 against their plain versions, then timed beside
    torch.matmul of the bf16 weight they replace (a yardstick only). Returns
    each kernel's numbers at WEIGHT_HEADLINE with every shape's by shape."""
    out = {"int8_linear": {"max_abs_err": 0.0, "by_shape": {}},
           "int4_linear": {"max_abs_err": 0.0, "by_shape": {}}}
    for m, k, n in WEIGHT_SHAPES + [WEIGHT_ODD]:
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        w = torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
        q8, q4 = quantize_weight(w), quantize_weight_int4(w)
        x4 = F.pad(x, (0, 2 * q4.packed.shape[0] - k))  # mm's padded contraction
        label = f"m={m} k={k} n={n}"
        e8 = _check_weight("int8_linear",
                           lambda dt: int8_weight_matmul(x, q8.w_i8, q8.scale, out_dtype=dt),
                           lambda dt: int8_weight_matmul_plain(x, q8.w_i8, q8.scale, dt), label)
        e4 = _check_weight(
            "int4_linear",
            lambda dt: int4_weight_matmul(x4, q4.packed, q4.scale, q4.group, out_dtype=dt),
            lambda dt: int4_weight_matmul_plain(x4, q4.packed, q4.scale, q4.group, dt), label)
        out["int8_linear"]["max_abs_err"] = max(out["int8_linear"]["max_abs_err"], e8)
        out["int4_linear"]["max_abs_err"] = max(out["int4_linear"]["max_abs_err"], e4)
        if (m, k, n) == WEIGHT_ODD:
            continue
        wb = w.to(torch.bfloat16)
        lib_ms = device_ms(lambda: torch.matmul(x, wb))
        y = torch.matmul(x, wb)
        for name, fn, plain, w_bytes in (
                ("int8_linear", lambda: int8_weight_matmul(x, q8.w_i8, q8.scale),
                 lambda: int8_weight_matmul_plain(x, q8.w_i8, q8.scale), nbytes(q8.w_i8, q8.scale)),
                ("int4_linear", lambda: int4_weight_matmul(x4, q4.packed, q4.scale, q4.group),
                 lambda: int4_weight_matmul_plain(x4, q4.packed, q4.scale, q4.group),
                 nbytes(q4.packed, q4.scale))):
            n_bytes = nbytes(x, y) + w_bytes
            r = {"ms": device_ms(fn), "plain_ms": device_ms(plain, calls=4, replays=5),
                 "library_ms": lib_ms, **bound(n_bytes, (2 * m * k * n, PEAK_BF16))}
            if m <= STREAM_MAX_M:  # streaming: the bytes are the bound
                r["gb_s"] = n_bytes / r["ms"] / 1e6
                rate = (f"{r['gb_s']:.1f} GB/s = {r['gb_s'] / (HBM_BYTES_S / 1e9):.1%} of "
                        f"{HBM_BYTES_S / 1e12:.2f} TB/s")
            else:  # tensor cores: the operations are
                r["tflop_s"] = 2 * m * k * n / r["ms"] / 1e9
                rate = f"{r['tflop_s']:.1f} TFLOP/s"
            out[name]["by_shape"][label] = r
            log(f"[timing] {name} {label}: kernel {r['ms']:.4f} ms ({rate}), plain "
                f"{r['plain_ms']:.4f} ms, bf16 torch.matmul {lib_ms:.4f} ms, bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    head = "m={} k={} n={}".format(*WEIGHT_HEADLINE)
    for name in out:
        out[name].update(out[name]["by_shape"][head])
        out[name]["library_call"] = "torch.matmul(x, w) with the weight in bf16"
        out[name]["headline_shape"] = head
    return out

# --------------------------------------------------------------------------
# The JVP family (B1 fp32, B9-B12) and the rCM DiT step
# --------------------------------------------------------------------------

JVP_KERNELS = ("flash_fwd_fp32", "jvp_fwd", "jvp_tangent", "jvp_bwd_dkv", "jvp_bwd_dq")
# the prep launches of B1 fp32, B9 fast and B11 + B12 fast (one shared by both)
JVP_PREPS = ("flash_fwd_fp32_prep", "jvp_fwd_prep", "jvp_bwd_prep")
# (b, h, t, s, causal): a square pair; the DiT's attention shape (the rCM
# step's); odd cross lengths; a ragged t < s; one token
JVP_CASES = [(2, 4, 1024, 1024, True), (2, 4, 1024, 1024, False),
             (DIT_BATCH, DIT_CFG.n_heads, DIT_CFG.seq_len, DIT_CFG.seq_len, False),
             (1, 4, 77, 201, True), (1, 4, 77, 201, False), (1, 3, 33, 130, True),
             (1, 3, 33, 130, False), (1, 2, 1, 1, True)]


# B1 fp32's tile edges (b, h, h_kv, t, s, causal)
FP32_EDGE_CASES = [(1, 2, 2, 330, 200, True), (1, 2, 2, 200, 330, True), (1, 6, 2, 129, 65, False),
                   (1, 2, 2, 1, 300, False), (1, 2, 2, 300, 1, True), (2, 4, 4, 128, 64, True)]


def _jvp_inputs(gen, dev, b, h, t, s, d=64):
    """q, k, v, tq, tk, tv, do, dto: unit normal f32 at head dim d."""
    q, tq, do, dto = (torch.randn((b, h, t, d), generator=gen, device=dev) for _ in range(4))
    k, v, tk, tv = (torch.randn((b, h, s, d), generator=gen, device=dev) for _ in range(4))
    return q, k, v, tq, tk, tv, do, dto


def _same_bits(kernel, first, second, label) -> None:
    """A second call of a kernel gave the first call's bits."""
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError(f"[jvp] {label}: a second {kernel} call gave other bits")


def _bits(x):
    """x's bytes as integers of its width (bf16 or f32), for byte equality."""
    return x.view(torch.int16 if x.element_size() == 2 else torch.int32)


def _check_jvp_preps(k, v, tk, tv, ops, label) -> None:
    """B1 fp32's K/V prep, B9 fast's K-side prep (on [b, h, s, d] views of
    [b, s, h, d] tensors) and B11/B12 fast's prep against their plain
    versions, byte for byte (the row terms are copies)."""
    got, want = kv_split_tf32(k, v), kv_split_tf32_plain(k, v)
    fwd_b, fwd_w = jvp_fwd_prep(*_strided(k, v, tk, tv)), jvp_fwd_prep_plain(k, v, tk, tv)
    (ops_b, rows), (ops_w, rows_w) = jvp_bwd_prep(ops), jvp_bwd_prep_plain(ops)
    torch.cuda.synchronize()
    pairs = [*zip(got, want), *zip(fwd_b, fwd_w), *zip(ops_b, ops_w), (rows, rows_w)]
    if not all(torch.equal(_bits(g), _bits(w)) for g, w in pairs):
        raise AssertionError(f"[jvp] {label}: a prep launch differs from its plain version")


def _check_jvp(q, k, v, tq, tk, tv, do, dto, causal, label, modes=(False, True),
               every_bit=False) -> dict:
    """B1 fp32 and B9-B12 in `modes` (exact False, fast True) against their
    plain versions on one case, by max|diff| / max|plain| per tensor (lse,
    and the gradients that vanish at one key: max|diff|), raising outside
    the tolerances; B1 fp32 and B9, B11 and B12 fast called twice for the
    same bits (B9 the second time on [b, t, h, d] views, B12 on a prep of
    its own), and their prep launches held byte for byte against the plain
    preps. `every_bit`: B10 (both modes) and B9, B11 and B12 exact called
    twice for the same bits too. Returns each kernel's max|diff|."""
    err, msgs = dict.fromkeys(JVP_KERNELS, 0.0), []
    absolute = {"lse"} | ({"dk", "dtk", "dq", "dtq"} if k.shape[2] == 1 else set())

    def hold(kernel, mode, tol, names, got, want):
        torch.cuda.synchronize()
        rel = {}
        for name, g, w in zip(names, got, want):
            diff = (g - w).abs().max().item()
            err[kernel] = max(err[kernel], diff)
            rel[name] = diff if name in absolute else diff / w.abs().max().item()
            if not torch.isfinite(g).all():
                raise AssertionError(f"[jvp] {label}: {kernel} {mode} {name} is not finite")
        msgs.append(f"{kernel} {mode} " + " ".join(f"{n} {x:.2e}" for n, x in rel.items()))
        if max(rel.values()) > tol:
            raise AssertionError(f"[jvp] {label}: {msgs[-1]} (tol {tol}): the kernel disagrees "
                                 "with its plain version")

    b1 = flash_attention_fwd_fp32(q, k, v, causal=causal)
    hold("flash_fwd_fp32", "fp32", JVP_EXACT_TOL, ("o", "lse"), b1,
         flash_attention_fwd_plain(q, k, v, causal=causal, precision="fp32"))
    _same_bits("flash_fwd_fp32", b1, flash_attention_fwd_fp32(q, k, v, causal=causal), label)
    for fast in modes:
        mode, tol = ("fast", BWD_FAST_TOL) if fast else ("exact", JVP_EXACT_TOL)
        fwd = attention_jvp_fwd(q, k, v, tq, tk, tv, causal=causal, fast=fast)
        hold("jvp_fwd", mode, JVP_FWD_FAST_TOL if fast else JVP_EXACT_TOL,
             ("o", "to", "lse", "mu"), fwd,
             attention_jvp_fwd_plain(q, k, v, tq, tk, tv, causal=causal, fast=fast))
        if fast:  # B9 reads q and tq through their strides, its prep k, v, tk and tv
            _same_bits("jvp_fwd", fwd, attention_jvp_fwd(*_strided(q, k, v, tq, tk, tv),
                                                         causal=causal, fast=True), label)
        elif every_bit:
            _same_bits("jvp_fwd", fwd, attention_jvp_fwd(q, k, v, tq, tk, tv, causal=causal),
                       label)
        o, to, lse, mu = fwd  # the kernel's residuals, as the entry points hand them on
        tangent = attention_tangent_fwd(q, k, v, o, lse, tq, tk, tv, causal=causal, fast=fast)
        hold("jvp_tangent", mode, tol, ("to",), [tangent],
             [attention_tangent_fwd_plain(q, k, v, o, lse, tq, tk, tv, causal=causal, fast=fast)])
        if every_bit:
            _same_bits("jvp_tangent", (tangent,), (attention_tangent_fwd(
                q, k, v, o, lse, tq, tk, tv, causal=causal, fast=fast),), label)
        ops = jvp_bwd_operands(q, k, v, tq, tk, tv, o, to, lse, mu, do, dto, causal=causal,
                               fast=fast)
        dkv = jvp_bwd_dkv(ops)
        hold("jvp_bwd_dkv", mode, tol, ("dk", "dv", "dtk", "dtv"), dkv, jvp_bwd_dkv_plain(ops))
        if fast or every_bit:
            _same_bits("jvp_bwd_dkv", dkv, jvp_bwd_dkv(ops), label)
        if fast:
            _check_jvp_preps(k, v, tk, tv, ops, label)
        dq = jvp_bwd_dq(ops)
        hold("jvp_bwd_dq", mode, tol, ("dq", "dtq"), dq, jvp_bwd_dq_plain(ops))
        if fast:  # on a prep handed in, as attention_jvp_bwd shares B11's
            _same_bits("jvp_bwd_dq", dq, jvp_bwd_dq(ops, jvp_bwd_prep(ops)), label)
        elif every_bit:
            _same_bits("jvp_bwd_dq", dq, jvp_bwd_dq(ops), label)
    log(f"[jvp] {label} (tol exact {JVP_EXACT_TOL}, fast B9 {JVP_FWD_FAST_TOL}, fast B10-B12 "
        f"{BWD_FAST_TOL}; B1 fp32, B9, B11 and B12 fast bit-equal on a second call"
        f"{', and B10 and the exact modes' if every_bit else ''}, the fast preps byte-equal): "
        + "; ".join(msgs))
    return err


def phase_jvp_kernels(dev, gen) -> dict:
    """Phase 17. Returns each kernel's worst max|diff| against its plain version."""
    errs = []
    for b, h, t, s, causal in JVP_CASES:
        errs.append(_check_jvp(*_jvp_inputs(gen, dev, b, h, t, s), causal,
                               f"b={b} h={h} t={t} s={s} causal={causal}"))
    # B10 exact on the DiT's [b, h, t, d] views of [b, t, h, d] tensors (O and
    # lse from B1 fp32), at the DiT's shape and the dit_jvp path's, whose keys
    # it splits into ranges: twice for the same bits, its prep byte-equal to
    # the plain prep
    msgs = []
    for b, h, t in ((DIT_BATCH, DIT_CFG.n_heads, DIT_CFG.seq_len),
                    (2, DIT_CFG.n_heads, DIT_PARITY_LEN)):
        label = f"({b},{h},{t},64) DiT views"
        q, k, v, tq, tk, tv = _strided(*_jvp_inputs(gen, dev, b, h, t, t)[:6])
        o, lse = flash_attention_fwd_fp32(q, k, v)
        got = attention_tangent_fwd(q, k, v, o, lse, tq, tk, tv)
        _same_bits("jvp_tangent", (got,), (attention_tangent_fwd(q, k, v, o, lse, tq, tk, tv),),
                   label)
        want = attention_tangent_fwd_plain(q, k, v, o, lse, tq, tk, tv)
        diff = (got - want).abs().max().item()
        rel = diff / want.abs().max().item()
        prep_ok = all(torch.equal(_bits(a), _bits(w_)) for a, w_ in
                      zip(tangent_prep(k, v, tk, tv), tangent_prep_plain(k, v, tk, tv)))
        _, z, per = jvp_tiling.tangent_grid(b * h, t, t, torch.cuda.get_device_properties(
            dev).multi_processor_count, 64)
        msgs.append(f"{label}: tO {rel:.2e} ({z} key ranges of {per} tiles)")
        if rel > JVP_EXACT_TOL or not torch.isfinite(got).all() or not prep_ok:
            raise AssertionError(f"[jvp] {label}: jvp_tangent exact {rel:.2e} (tol "
                                 f"{JVP_EXACT_TOL}), prep byte-equal {prep_ok}")
        errs.append({**dict.fromkeys(JVP_KERNELS, 0.0), "jvp_tangent": diff})
        del q, k, v, tq, tk, tv, o, lse, got, want
    log(f"[jvp] jvp_tangent exact (3xTF32) vs plain, max|diff|/max|plain| (tol {JVP_EXACT_TOL}; "
        "bit-equal on a second call, prep byte-equal): " + "; ".join(msgs))
    # B1's fp32 mode is GQA-native, as its bf16 mode: rep 4, a ragged length
    q, k, v, _ = _qkvdo(gen, dev, 2, 8, 2, 300, 300)
    o, lse = flash_attention_fwd_fp32(q, k, v, causal=True)
    _same_bits("flash_fwd_fp32", (o, lse), flash_attention_fwd_fp32(q, k, v, causal=True),
               "GQA (2,8q/2kv,300,64)")
    o_p, lse_p = flash_attention_fwd_plain(q, k, v, causal=True, precision="fp32")
    err_o = (o - o_p).abs().max().item()
    err_l = (lse - lse_p).abs().max().item()
    rel_o = err_o / o_p.abs().max().item()
    log(f"[jvp] flash_fwd_fp32 GQA (2,8q/2kv,300,64) causal: max|dO|/max|plain| {rel_o:.2e}, "
        f"max|dlse| {err_l:.2e} (tol {JVP_EXACT_TOL})")
    if max(rel_o, err_l) > JVP_EXACT_TOL:
        raise AssertionError("flash_fwd_fp32 disagrees with its plain version under GQA")
    errs.append({**dict.fromkeys(JVP_KERNELS, 0.0), "flash_fwd_fp32": err_o})
    # B1 fp32's tile edges: t > s and t < s causal, ragged 64-key and
    # 128-position tiles, rep 3, one query, one key
    msgs = []
    for b, h, h_kv, t, s, causal in FP32_EDGE_CASES:
        label = f"({b},{h}q/{h_kv}kv,{t}x{s},64) causal={causal}"
        q, k, v, _ = _qkvdo(gen, dev, b, h, h_kv, t, s)
        got = flash_attention_fwd_fp32(q, k, v, causal=causal)
        _same_bits("flash_fwd_fp32", got, flash_attention_fwd_fp32(q, k, v, causal=causal), label)
        o_p, lse_p = flash_attention_fwd_plain(q, k, v, causal=causal, precision="fp32")
        err = (got[0] - o_p).abs().max().item()
        rel, err_l = err / o_p.abs().max().item(), (got[1] - lse_p).abs().max().item()
        msgs.append(f"{label} O {rel:.2e} lse {err_l:.2e}")
        if max(rel, err_l) > JVP_EXACT_TOL or not torch.isfinite(got[0]).all():
            raise AssertionError(f"flash_fwd_fp32 disagrees with its plain version at {label}")
        errs.append({**dict.fromkeys(JVP_KERNELS, 0.0), "flash_fwd_fp32": err})
    log(f"[jvp] flash_fwd_fp32 tile edges (tol {JVP_EXACT_TOL}; each bit-equal on a second "
        "call): " + "; ".join(msgs))
    return _worst(*errs)


def _jvp_launches() -> dict:
    counts = _launch_counts()
    return {k: counts[k] for k in (*JVP_KERNELS, *JVP_PREPS, "flash_bwd_dkv", "flash_bwd_dq",
                                   "flash_fwd")}


def _within(got, want, tol) -> tuple[bool, float]:
    """|got - want| <= tol + tol |want| everywhere (rtol = atol = tol), and max|diff|."""
    diff = (got - want).abs()
    return bool((diff <= tol + tol * want.abs()).all()), diff.max().item()


def phase_jvp_oracle(dev, gen, d: int = 64) -> dict:
    """Phase 18, BASELINE config 5's gate and the JVP family's AD against the
    fp32 oracle (phase 30 at head dim 128). The path run: every launch count
    from 0; returns the JVP kernels' (and B2/B3's) launches over the
    phase."""
    _reset_counts()
    b, h, t = 1, 2, DIT_CFG.seq_len
    q, k, v, tq, tk, tv, _, _ = _jvp_inputs(gen, dev, b, h, t, t, d)
    o_w, to_w = reference_attention_jvp((q, k, v), (tq, tk, tv))
    o, to = attention_value_and_jvp(q, k, v, tq, tk, tv)
    o_j, to_j = torch.func.jvp(attention_jvp, (q, k, v), (tq, tk, tv))
    o_f, to_f = attention_value_and_jvp(q, k, v, tq, tk, tv, fast=True)
    reps = [mismatch_report(n, g, w, CONFIG5_ATOL) for n, g, w in (
        ("value_and_jvp O", o, o_w), ("value_and_jvp tO", to, to_w),
        ("func.jvp(attention_jvp) O", o_j, o_w), ("func.jvp(attention_jvp) tO", to_j, to_w))]
    fast_ok_o, fast_o = _within(o_f, o, JVP_FAST_O)
    fast_ok_t, fast_t = _within(to_f, to, JVP_FAST_TO)
    log(f"[jvp_oracle] config 5 ({b},{h},{t},{d}) vs the fp32 oracle: " + "; ".join(map(str, reps))
        + f"; fast vs exact max|dO| {fast_o:.3e} (tol {JVP_FAST_O}), max|dtO| {fast_t:.3e} "
        f"(tol {JVP_FAST_TO})")
    if any(r.mismatches for r in reps) or not (fast_ok_o and fast_ok_t):
        raise AssertionError("the JVP entry points fail BASELINE config 5's gate")
    del q, k, v, tq, tk, tv, o_w, to_w, o, to, o_j, to_j, o_f, to_f

    for causal in (False, True):
        q, k, v, tq, tk, tv, wo, wt = _jvp_inputs(gen, dev, 1, 2, 256, 256, d)

        def loss(pair):
            return (torch.sin(pair[0]) * wo).sum() + (pair[1] * wt).sum() + pair[1].square().sum()

        leaves = [x.clone().requires_grad_(True) for x in (q, k, v, tq, tk, tv)]
        got = torch.autograd.grad(loss(attention_value_and_jvp(*leaves, causal=causal)), leaves)
        ref = [x.clone().requires_grad_(True) for x in (q, k, v, tq, tk, tv)]
        want = torch.autograd.grad(loss(reference_attention_jvp(ref[:3], ref[3:], causal)), ref)
        res = [_within(g, w, JVP_GRAD_TOL) for g, w in zip(got, want)]
        leaves = leaves[:3]
        got_j = torch.autograd.grad(attention_jvp(*leaves, causal=causal), leaves, wo)
        want_j = reference_attention_vjp(q, k, v, wo, causal=causal)
        res_j = [_within(g, w, JVP_GRAD_TOL) for g, w in zip(got_j, want_j)]
        log(f"[jvp_oracle] (1,2,256,{d}) causal={causal}: value_and_jvp grads vs autograd through "
            "torch.func.jvp of the oracle, max|diff| "
            + " ".join(f"d{n} {r[1]:.2e}" for n, r in zip(("q", "k", "v", "tq", "tk", "tv"), res))
            + "; attention_jvp grads vs the oracle's "
            + " ".join(f"d{n} {r[1]:.2e}" for n, r in zip("qkv", res_j))
            + f" (rtol = atol = {JVP_GRAD_TOL})")
        if not all(r[0] for r in res + res_j):
            raise AssertionError("JVP gradients outside the JAX package's envelope")
    launches = _jvp_launches()
    if not all(launches[k] for k in (*JVP_KERNELS, "flash_bwd_dkv", "flash_bwd_dq")) \
            or launches["flash_fwd"]:
        raise AssertionError(f"the oracle phase launched {launches}")
    return launches


def phase_jvp_timing(dev, gen, d=64) -> dict:
    """Phase 19 (phase 30 at d=128): device time per call of B1 fp32 and
    B9-B12 (both modes) at the DiT's attention shape beside their plain
    versions, and at bench.py's bench_jvp shape, on [b, h, t, d] views of
    [b, t, h, d] tensors as the DiT hands them; B1 fp32 beside SDPA on the
    same f32 inputs. The row's `ms`, `plain_ms` and `bound_ms` are at the DiT
    shape in the mode its main path runs (B9, B11, B12 fast as the rCM step;
    B10 exact as attention_jvp; B1 fp32); `other_ms` is the other mode's. B1
    fp32's, B9's and B11's `ms` are whole calls (`prep_ms` + `kernel_ms`);
    B12's is its kernel on B11's prep, as the rCM step runs it (`call_ms`: a
    call that runs its own prep). B10 exact is also timed at the dit_jvp
    path's shape (`dit_jvp_ms`). At head dim 128 (phase 30) the DiT's
    shape alone: no `bench_` entries."""
    modes = (True, False)
    dit = {64: (DIT_BATCH, DIT_CFG.n_heads, DIT_CFG.seq_len), HEAD128: DIT128_SHAPE}[d]
    bench = d == 64
    shapes = (("", dit), ("bench_", JVP_BENCH_SHAPE)) if bench else (("", dit),)
    out = {k: {} for k in JVP_KERNELS}

    def few(fn):  # calls of milliseconds and more: one call a graph, two replays
        return device_ms(fn, calls=1, replays=2)

    for tag, (b, h, t) in shapes:
        q, k, v, tq, tk, tv, do, dto = _strided(*_jvp_inputs(gen, dev, b, h, t, t, d))
        prod = 2 * b * h * t * t * d  # one product over every (q, k) pair
        o, lse = flash_attention_fwd_fp32(q, k, v)
        fwd = {m: attention_jvp_fwd(q, k, v, tq, tk, tv, fast=m) for m in modes}
        ops = {m: jvp_bwd_operands(q, k, v, tq, tk, tv, *fwd[m], do, dto, fast=m) for m in modes}
        dkv, dq = jvp_bwd_dkv(ops[True]), jvp_bwd_dq(ops[True])
        io = {"jvp_fwd": nbytes(q, k, v, tq, tk, tv, *fwd[True]),
              "jvp_tangent": nbytes(q, k, v, tq, tk, tv, o, lse, fwd[True][1]),
              "jvp_bwd_dkv": nbytes(*ops[True][:12], *dkv),
              "jvp_bwd_dq": nbytes(*ops[True][:12], *dq)}
        dots = {"jvp_fwd": 6, "jvp_tangent": 5, "jvp_bwd_dkv": 12, "jvp_bwd_dq": 9}
        calls = {"jvp_fwd": lambda m: attention_jvp_fwd(q, k, v, tq, tk, tv, fast=m),
                 "jvp_tangent": lambda m: attention_tangent_fwd(q, k, v, o, lse, tq, tk, tv,
                                                                fast=m),
                 "jvp_bwd_dkv": lambda m: jvp_bwd_dkv(ops[m]),
                 "jvp_bwd_dq": lambda m: jvp_bwd_dq(ops[m], prep if m else None)}
        plains = {"jvp_fwd": lambda m: attention_jvp_fwd_plain(q, k, v, tq, tk, tv, fast=m),
                  "jvp_tangent": lambda m: attention_tangent_fwd_plain(q, k, v, o, lse, tq, tk,
                                                                       tv, fast=m),
                  "jvp_bwd_dkv": lambda m: jvp_bwd_dkv_plain(ops[m]),
                  "jvp_bwd_dq": lambda m: jvp_bwd_dq_plain(ops[m])}
        r = out["flash_fwd_fp32"]
        r[f"{tag}ms"] = few(lambda: flash_attention_fwd_fp32(q, k, v))
        r[f"{tag}prep_ms"] = few(lambda: kv_split_tf32(k, v))
        r[f"{tag}kernel_ms"] = r[f"{tag}ms"] - r[f"{tag}prep_ms"]
        r[f"{tag}library_ms"] = few(lambda: F.scaled_dot_product_attention(q, k, v))
        # the kernel's work, 3xTF32: 6 TF32 products; the same function on
        # the CUDA cores: 2 fp32 products
        b1 = bound(nbytes(q, k, v, o, lse), (6 * prod, PEAK_TF32))
        r.update({f"{tag}{key}": val for key, val in b1.items()})
        r[f"{tag}fp32_bound_ms"] = bound(nbytes(q, k, v, o, lse), (2 * prod, PEAK_FP32))["bound_ms"]
        if not tag:
            r["plain_ms"] = few(lambda: flash_attention_fwd_plain(q, k, v, precision="fp32"))
        # B9 fast's and B11 fast's calls, split into their prep launch and the
        # kernel; B12 fast on B11's prep, and as a call of its own
        prep = jvp_bwd_prep(ops[True])
        out["jvp_fwd"][f"{tag}prep_ms"] = few(lambda: jvp_fwd_prep(k, v, tk, tv))
        out["jvp_bwd_dkv"][f"{tag}prep_ms"] = few(lambda: jvp_bwd_prep(ops[True]))
        out["jvp_bwd_dq"][f"{tag}call_ms"] = few(lambda: jvp_bwd_dq(ops[True]))
        for name in (n for n in dots if n in out):
            main = name != "jvp_tangent"  # fast for the rCM step's kernels
            r = out[name]
            r[f"{tag}ms"] = few(lambda: calls[name](main))
            if name in ("jvp_fwd", "jvp_bwd_dkv"):
                r[f"{tag}kernel_ms"] = r[f"{tag}ms"] - r[f"{tag}prep_ms"]
            r[f"{tag}other_ms"] = few(lambda: calls[name](not main))
            for fast in modes:
                key = "" if fast == main else "other_"
                bnd = bound(io[name], (dots[name] * prod, PEAK_BF16 if fast else PEAK_FP32))
                r[f"{tag}{key}bound_ms"] = bnd["bound_ms"]
                r[f"{tag}{key}bound_by"] = bnd["bound_by"]
            if name == "jvp_tangent":  # exact runs 3xTF32: 15 TF32 products
                r[f"{tag}fp32_bound_ms"] = r[f"{tag}bound_ms"]
                bnd = bound(io[name], (3 * dots[name] * prod, PEAK_TF32))
                r[f"{tag}bound_ms"], r[f"{tag}bound_by"] = bnd["bound_ms"], bnd["bound_by"]
            if not tag:
                r["plain_ms"] = few(lambda: plains[name](main))
        del q, k, v, tq, tk, tv, do, dto, o, lse, fwd, ops, dkv, dq, prep
    # B10 exact at the dit_jvp path's shape: torch.func.jvp(dit_forward) at
    # seq DIT_PARITY_LEN, batch 2 (phase 20; phase 30 at DIT128_CFG)
    b, h, t = 2, DIT_CFG.n_heads, DIT_PARITY_LEN
    q, k, v, tq, tk, tv, _, _ = _strided(*_jvp_inputs(gen, dev, b, h, t, t, d))
    o, lse = flash_attention_fwd_fp32(q, k, v)
    r = out["jvp_tangent"]
    r["dit_jvp_shape"] = f"({b},{h},{t},{d})"
    r["dit_jvp_ms"] = device_ms(lambda: attention_tangent_fwd(q, k, v, o, lse, tq, tk, tv))
    to = attention_tangent_fwd(q, k, v, o, lse, tq, tk, tv)
    io, prod = nbytes(q, k, v, tq, tk, tv, o, lse, to), 2 * b * h * t * t * d
    bnd = bound(io, (15 * prod, PEAK_TF32))
    r["dit_jvp_bound_ms"], r["dit_jvp_bound_by"] = bnd["bound_ms"], bnd["bound_by"]
    r["dit_jvp_fp32_bound_ms"] = bound(io, (5 * prod, PEAK_FP32))["bound_ms"]
    r["bound_kind"] = ("exact: 3xTF32 on the tensor cores (15 TF32 products); fp32_bound_ms: 5 "
                       "fp32 products on FFMA; other (fast): 5 bf16 products")

    def at(text, r):  # the DiT's shape, then bench_jvp's where it was timed
        return text.format(p="").format(**r) + (
            f"; {r['bench_shape']}: " + text.format(p="bench_").format(**r) if bench else "")

    for name, r in out.items():
        r["mode"] = {"flash_fwd_fp32": "fp32", "jvp_tangent": "exact"}.get(name, "fast")
        r["shape"] = "({},{},{},{}) DiT views, non-causal".format(*dit, d)
        if bench:
            r["bench_shape"] = "({},{},{},{})".format(*JVP_BENCH_SHAPE, d)
        if name == "flash_fwd_fp32":
            r["library_call"] = "F.scaled_dot_product_attention, f32 inputs"
            r["bound_kind"] = "3xTF32 on the tensor cores; fp32_bound_ms: 2 fp32 products on FFMA"
            log(f"[timing] flash_fwd_fp32, plain {r['plain_ms']:.4f} ms; {r['shape']}: " + at(
                "call {{{p}ms:.4f}} ms = prep {{{p}prep_ms:.4f}} + kernel {{{p}kernel_ms:.4f}}, "
                "sdpa f32 {{{p}library_ms:.4f}} ms, bound 3xTF32 {{{p}bound_ms:.4f}} ms, fp32 "
                "CUDA cores {{{p}fp32_bound_ms:.4f}} ms", r))
            continue
        r["library_ms"] = None
        r["library_call"] = "none (no single call)"
        other = ", other mode {{{p}other_ms:.4f}} ms (bound {{{p}other_bound_ms:.4f}})"
        log(f"[timing] {name} {r['mode']}, plain {r['plain_ms']:.4f} ms; {r['shape']}: " + at(
            "{{{p}ms:.4f}} ms (bound {{{p}bound_ms:.4f}})" + other, r))
        if name in ("jvp_fwd", "jvp_bwd_dkv"):
            log(f"[timing] {name} fast call = prep + kernel: {r['shape']}: "
                + at("{{{p}prep_ms:.4f}} + {{{p}kernel_ms:.4f}} ms", r))
        elif name == "jvp_bwd_dq":
            r["ms_of"] = "the kernel on B11's prep, as the rCM step launches it"
            log(f"[timing] jvp_bwd_dq fast: {r['shape']}: " + at(
                "kernel on B11's prep {{{p}ms:.4f}} ms, a call with its own prep "
                "{{{p}call_ms:.4f}}", r))
        elif name == "jvp_tangent":
            log(f"[timing] jvp_tangent exact at the dit_jvp shape {r['dit_jvp_shape']}: "
                f"{r['dit_jvp_ms']:.4f} ms (bound 3xTF32 {r['dit_jvp_bound_ms']:.4f}, fp32 CUDA "
                f"cores {r['dit_jvp_fp32_bound_ms']:.4f}); fp32 CUDA-core bounds: DiT "
                f"{r['fp32_bound_ms']:.4f}"
                + (f", bench {r['bench_fp32_bound_ms']:.4f}" if bench else "") + " ms")
    return out


def _dit_params(dev, cfg, seed=0):
    """init_dit's params with `ada` and `out` drawn at 1/sqrt(fan_in): at the
    JAX init (both zero) attention would not reach the loss at all."""
    params = init_dit(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    d = cfg.d_model
    params["out"] = torch.randn((d, d), generator=gen, device=dev) / d ** 0.5
    for layer in params["layers"]:
        layer["ada"] = torch.randn((d, 6 * d), generator=gen, device=dev) / d ** 0.5
    return params


def _dit_copy(params, device):
    """A detached copy of DiT params on `device`, every tensor a leaf that
    requires grad (a copy on their own device too: an optimizer steps it in
    place)."""
    def leaf(x):
        return x.detach().to(device, copy=True).requires_grad_(True)

    out = {k: leaf(params[k]) for k in ("t_mlp1", "t_mlp2", "out")}
    out["layers"] = [{k: leaf(x) for k, x in layer.items()} for layer in params["layers"]]
    return out


def _dit_checks(dev, params, x, t, cfg=DIT_CFG, modes=(True,)) -> dict:
    """At seq DIT_PARITY_LEN: the rCM loss and every gradient on the card
    against the CPU plain path in each of `modes` (fast True, exact False),
    (u, du/dt) against finite differences (central), and torch.func.jvp of
    dit_forward (default attention) through B10 once a layer, every launch
    count from 0. Returns that jvp run's launches."""
    cfg = dataclasses.replace(cfg, seq_len=DIT_PARITY_LEN)
    xs, ts = x[:2, :DIT_PARITY_LEN].contiguous(), t[:2].contiguous()
    for fast in modes:
        res = {}
        for device in (dev, "cpu"):
            copy = _dit_copy(params, device)
            loss = rcm_loss(copy, xs.to(device), ts.to(device), cfg, fast=fast)
            res[str(device)] = (loss.item(), torch.autograd.grad(loss, dit_param_leaves(copy)))
        (loss_c, grads_c), (loss_p, grads_p) = res[str(dev)], res["cpu"]
        rels = [((g.cpu() - w).norm() / w.norm()).item() for g, w in zip(grads_c, grads_p)]
        loss_rel = abs(loss_c - loss_p) / abs(loss_p)
        zero = [i for i, g in enumerate(grads_c) if not g.abs().max() > 0]
        log(f"[dit] head_dim {cfg.head_dim}: rCM loss on the card vs CPU plain path (2 x "
            f"{DIT_PARITY_LEN} tokens, {'fast' if fast else 'exact'}): {loss_c:.6f} vs "
            f"{loss_p:.6f} (rel {loss_rel:.2e}); grad rel L2 max {max(rels):.3e} median "
            f"{statistics.median(rels):.3e} over {len(rels)} tensors (tol {DIT_GRAD_REL_L2}); "
            f"zero gradients: {zero}")
        if not (loss_rel <= DIT_GRAD_REL_L2 and max(rels) <= DIT_GRAD_REL_L2 and not zero):
            raise AssertionError("rCM gradients on the card disagree with the CPU plain path")

    with torch.no_grad():
        p = _dit_copy(params, dev)
        u, du = dit_jvp_step(p, xs, ts, cfg, fast=True)
        v = dit_forward(p, xs, ts, cfg)
        eps = 1e-3  # central differences: with `ada` and `out` nonzero the DiT
        # curves enough that a one-sided difference is off by ~1e-1 at this eps
        fd = (dit_forward(p, xs + eps * v, ts + eps, cfg)
              - dit_forward(p, xs - eps * v, ts - eps, cfg)) / (2 * eps)
        rel_fd = ((fd - du).norm() / du.norm()).item()
        _reset_counts()
        _, du_j = torch.func.jvp(lambda x_, t_: dit_forward(p, x_, t_, cfg), (xs, ts),
                                 (v, torch.ones_like(ts)))
        torch.cuda.synchronize()
        launches = _jvp_launches()
    rel_j = ((du_j - du).norm() / du_j.norm()).item()
    log(f"[dit] head_dim {cfg.head_dim}, (u, du/dt) at seq {DIT_PARITY_LEN}: du/dt vs central "
        f"differences rel L2 "
        f"{rel_fd:.3e} (tol 0.05); torch.func.jvp(dit_forward) (exact, B10) vs the fast pair "
        f"path rel L2 {rel_j:.3e} (tol {DIT_JVP_REL_L2}); its launches {launches}")
    want = {k: 0 for k in launches}
    want.update(flash_fwd_fp32=cfg.n_layers, flash_fwd_fp32_prep=cfg.n_layers,
                jvp_tangent=cfg.n_layers)
    if not (rel_fd < 0.05 and rel_j <= DIT_JVP_REL_L2 and launches == want):
        raise AssertionError("dit_jvp_step disagrees with finite differences or with "
                             "torch.func.jvp of dit_forward, or the forward-mode DiT did not "
                             "run B10 once a layer")
    return launches


# each rCM step runs the fp32 prepass (B1 fp32 and its prep), B9 forward (and
# its prep), B11 + B12 backward (and their one shared prep)
DIT_STEP_KERNELS = ("flash_fwd_fp32", "flash_fwd_fp32_prep", "jvp_fwd", "jvp_fwd_prep",
                    "jvp_bwd_prep", "jvp_bwd_dkv", "jvp_bwd_dq")


def phase_dit(dev, smi, cfg=DIT_CFG, profile=True, modes=(True,)) -> tuple[dict, dict, dict]:
    """Phase 20, BASELINE config 5 (phase 30 at DIT128_CFG, with the
    card-vs-CPU parity in both `modes`). Returns (the 5 timed steps' launches
    of the JVP kernels, the seq-512 jvp run's, step numbers)."""
    params = _dit_params(dev, cfg)
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((DIT_BATCH, cfg.seq_len, cfg.d_model), generator=gen, device=dev)
    t = torch.rand((DIT_BATCH,), generator=gen, device=dev)
    jvp_launches = _dit_checks(dev, params, x, t, cfg, modes)

    _, step = make_dit_rcm_step(cfg, params, fast=True)
    losses = [step(x, t)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counts()
    per_step, times = [], []
    for _ in range(DIT_STEPS):
        before = _launch_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(step(x, t))
        end.record()
        times.append((start, end))
        per_step.append({k: n - before[k] for k, n in _launch_counts().items()})
    torch.cuda.synchronize()
    losses = torch.stack(losses).tolist()
    step_ms = [s.elapsed_time(e) for s, e in times]
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"rCM losses not finite and falling: {losses}")
    want = {k: cfg.n_layers if k in DIT_STEP_KERNELS else 0 for k in _COUNTED}
    want["jvp_bwd_dkv"] *= jvp_tiling.dkv_parts(cfg.head_dim)  # B11's grid launches a call
    if any(c != want for c in per_step):
        raise AssertionError(f"kernel launches per rCM step {per_step}, want {want}")
    med = statistics.median(step_ms)
    mem = torch.cuda.max_memory_allocated(dev) / 2**30
    tokens = DIT_BATCH * cfg.seq_len
    log(f"[dit] rCM step, fast, DiT d_model {cfg.d_model}, {cfg.n_heads} heads x "
        f"{cfg.head_dim}, {cfg.n_layers} "
        f"layers, {DIT_BATCH} x {cfg.seq_len} tokens on {smi}: median step {med:.2f} ms (min "
        f"{min(step_ms):.2f}, max {max(step_ms):.2f}; CUDA events), {tokens / med * 1e3:.0f} "
        f"tokens/s, max_memory_allocated {mem:.2f} GiB, launches per step "
        f"{ {k: n for k, n in per_step[0].items() if n} }; losses {[round(v, 6) for v in losses]}")
    if profile:
        _profile_dit_step(step, x, t)
    launches = {k: sum(c[k] for c in per_step) for k in (*JVP_KERNELS, *JVP_PREPS)}
    return launches, jvp_launches, {"median_ms": med, "max_memory_gib": mem,
                                    "tokens_per_s": tokens / med * 1e3, "losses": losses}


DIT_EXACT_STEPS = 3  # timed exact rCM steps at DIT128_CFG, after one untimed
DIT_JVP_CALLS = 5  # timed torch.func.jvp(dit_forward) calls at full size
# each exact rCM step runs the fp32 prepass (B1 fp32 and its prep), B9
# exact forward and B11 + B12 exact backward, and no prep of the fast modes
DIT_EXACT_STEP_KERNELS = ("flash_fwd_fp32", "flash_fwd_fp32_prep", "jvp_fwd", "jvp_bwd_dkv",
                          "jvp_bwd_dq")


def _dit_exact(dev, smi, cfg) -> tuple[dict, dict]:
    """Phase 30's DiT in exact mode at full size (batch DIT_BATCH, seq
    cfg.seq_len): torch.func.jvp of dit_forward (B1 fp32 with its prep, then
    B10 exact, once a layer a call) timed by CUDA events, median of
    DIT_JVP_CALLS, with its launches; then make_dit_rcm_step(fast=False) for
    1 + DIT_EXACT_STEPS steps: losses finite, launches a step exactly those
    of DIT_EXACT_STEP_KERNELS n_layers times each, median step and peak
    memory. Every count from 0 before each run. Returns (launches by path,
    numbers)."""
    params = _dit_params(dev, cfg)
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((DIT_BATCH, cfg.seq_len, cfg.d_model), generator=gen, device=dev)
    t = torch.rand((DIT_BATCH,), generator=gen, device=dev)
    n = cfg.n_layers

    def events(fn, calls):
        out, times = [], []
        for _ in range(calls):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out.append(fn())
            end.record()
            times.append((start, end))
        torch.cuda.synchronize()
        return out, [a.elapsed_time(b) for a, b in times]

    with torch.no_grad():
        v = dit_forward(params, x, t, cfg)
        one = torch.ones_like(t)

        def fwd_jvp():
            return torch.func.jvp(lambda x_, t_: dit_forward(params, x_, t_, cfg), (x, t),
                                  (v, one))[1]

        fwd_jvp()  # warm-up: the kernels' first calls set their attributes
        torch.cuda.synchronize()
        _reset_counts()
        outs, jvp_ms = events(fwd_jvp, DIT_JVP_CALLS)
        jvp_launches = {k: c for k, c in _launch_counts().items() if c}
    want = {"flash_fwd_fp32": DIT_JVP_CALLS * n, "flash_fwd_fp32_prep": DIT_JVP_CALLS * n,
            "jvp_tangent": DIT_JVP_CALLS * n}
    finite = all(torch.isfinite(du).all() for du in outs)
    same = all(torch.equal(du, outs[0]) for du in outs)
    log(f"[dit] head_dim {cfg.head_dim}: torch.func.jvp(dit_forward), {DIT_BATCH} x "
        f"{cfg.seq_len} tokens, {n} layers, on {smi}: median {statistics.median(jvp_ms):.2f} ms "
        f"(min {min(jvp_ms):.2f}, max {max(jvp_ms):.2f}; CUDA events, {DIT_JVP_CALLS} calls); "
        f"launches {jvp_launches}; du/dt finite {finite}, the same bits every call {same}")
    if jvp_launches != want or not finite:
        raise AssertionError(f"torch.func.jvp(dit_forward) at head_dim {cfg.head_dim} launched "
                             f"{jvp_launches}, want {want}, or its du/dt is not finite")
    del outs, v

    _, step = make_dit_rcm_step(cfg, params, fast=False)
    losses = [step(x, t)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counts()
    per_step = []

    def one_step():
        before = _launch_counts()
        loss = step(x, t)
        per_step.append({k: c - before[k] for k, c in _launch_counts().items()})
        return loss

    more, step_ms = events(one_step, DIT_EXACT_STEPS)
    losses = torch.stack(losses + more).tolist()
    mem = torch.cuda.max_memory_allocated(dev) / 2**30
    want_step = {k: n if k in DIT_EXACT_STEP_KERNELS else 0 for k in _COUNTED}
    med = statistics.median(step_ms)
    tokens = DIT_BATCH * cfg.seq_len
    log(f"[dit] rCM step, exact, DiT d_model {cfg.d_model}, {cfg.n_heads} heads x "
        f"{cfg.head_dim}, {n} layers, {DIT_BATCH} x {cfg.seq_len} tokens on {smi}: median step "
        f"{med:.2f} ms (min {min(step_ms):.2f}, max {max(step_ms):.2f}; CUDA events), "
        f"{tokens / med * 1e3:.0f} tokens/s, max_memory_allocated {mem:.2f} GiB, launches per "
        f"step { {k: c for k, c in per_step[0].items() if c} }; losses "
        f"{[round(x_, 6) for x_ in losses]}")
    if not all(np.isfinite(losses)) or any(c != want_step for c in per_step):
        raise AssertionError(f"exact rCM steps: losses {losses}, launches per step {per_step}, "
                             f"want {want_step}")
    steps = {k: sum(c[k] for c in per_step) for k in DIT_EXACT_STEP_KERNELS}
    return ({"dit_jvp128": jvp_launches, "dit_rcm128_exact": {k: c for k, c in steps.items() if c}},
            {"dit_jvp128_ms": statistics.median(jvp_ms), "dit_jvp128_calls_ms": jvp_ms,
             "dit_rcm128_exact": {"median_ms": med, "max_memory_gib": mem,
                                  "tokens_per_s": tokens / med * 1e3, "losses": losses,
                                  "steps_ms": step_ms}})


def _profile_dit_step(step, x, t):
    """torch.profiler over one rCM step: device time by kernel, and busy share."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(x, t)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    total_us = sum(e.self_device_time_total for e in events)
    log(f"[profile] one rCM step: wall {wall_ms:.2f} ms (profiled), device busy "
        f"{total_us / 1e3:.2f} ms ({total_us / 1e3 / wall_ms:.1%} of wall)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d} calls  "
            f"{e.self_device_time_total / total_us:6.1%}  {e.key[:90]}")

# --------------------------------------------------------------------------
# Mesh serving (phase 26)
# --------------------------------------------------------------------------

# a bf16 mesh run rounds each layer's two partial out and down projections
# to bf16 before the psum adds them, where the one-device product rounds
# once: about one bf16 ulp on each of the 2 x n_layers residual updates. A
# request's first token that differs from the one-device run's is a fault
# unless the one-device run's top-2 logit gap there (f32, from an exact
# replay) is below this many bf16 ulps of its top logit, or below
# SPEC_TIE_GAP
MESH_TIE_ULPS = 4
MESH_CASES = {  # label -> (engine options, whether tokens must equal the one-device run's)
    "f32": ({}, True),
    "bf16": ({"param_dtype": torch.bfloat16}, False),
    "kv4": ({"kv_quant": "int4"}, True),
    "paged": ({"cache": "paged"}, True),
    "w8": ({"param_dtype": torch.bfloat16, "weight_quant": "int8"}, False),
    "spec": ({"spec_decode": SPEC_K, "decode_horizon": 1}, True),
}
MESH_KERNEL_ROW = {"verify": "decode", "paged_verify": "paged_decode", "verify4": "decode4",
                   "paged4_verify": "paged4_decode"}


def _one_device_serve(dev, params, prompts, runs=1, **kw):
    """(each request's tokens, the last run's tokens/s, the engine) of the
    one-device engine on phase 26's requests."""
    eng = ServingEngine(params, BENCH_CFG, dev, n_slots=N_SLOTS, scheduler="native",
                        decode_horizon=HORIZON, **kw)
    for _ in range(runs):
        rids = [eng.submit(p, NEW_TOKENS) for p in prompts]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return [out[r].tokens for r in rids], N_SLOTS * NEW_TOKENS / wall, eng


def _first_gaps(eng, prompts, want, got, kv_quant) -> dict:
    """{request: (token index, f32 gap, bf16 gap, top logit)} at each
    request's first token that differs: the one-device run's top-2 logit
    gap there, from `_plain_gaps`' exact replay (a prefill token from the
    logits of transformer_forward over the prompt)."""
    firsts = {i: next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
              for i, (a, b) in enumerate(zip(got, want)) if a != b}
    later = {i: t for i, t in firsts.items() if t > 0}
    gaps = _plain_gaps(eng.params, prompts, want, later, kv_quant, BENCH_CFG) if later else {}
    for i in (i for i, t in firsts.items() if t == 0):
        with torch.no_grad():
            lg = transformer_forward(eng.params, torch.tensor([prompts[i]], device=eng.device),
                                     BENCH_CFG)[0, -1]
        top16 = torch.topk(lg.float(), 2).values
        gaps[i] = ((top16[0] - top16[1]).item(), (top16[0] - top16[1]).item(), top16[0].item())
    return {i: (t, *gaps[i]) for i, t in firsts.items()}


MESH_LENGTHS = [0, 127, 1000, BENCH_CFG.max_seq]
# a spec_decode=SPEC_K engine's slotted rows: max_seq and 128 slack tokens
MESH_SPEC_LEN, MESH_SPEC_LENGTHS = BENCH_CFG.max_seq + 128, [0, 3, 1000, BENCH_CFG.max_seq + SPEC_K]


def _check_mesh_kernels(dev) -> dict:
    """Phase 26's attention kernels at one rank's shapes, on card 0, against
    their plain versions: B1 on a (1, MESH_HEADS, 256, 64) prompt, f32 and
    bf16 in (FLASH_O_TOL, FLASH_LSE_TOL); B13-B16 at MESH_ROWS rows x
    MESH_HEADS q / kv heads, lengths MESH_LENGTHS, shuffled pages, junk pages
    and non-finite stale scales (DECODE_TOL); B13's verify at spec SPEC_K + 1
    on the spec engine's MESH_SPEC_LEN-token rows (DECODE_TOL, each row
    bit-equal to spec 1). Each kernel then timed at its mesh decode or
    prefill shape beside its plain version and bound. B17 at its mesh shapes
    is held and timed in phase 15 (WEIGHT_SHAPES). Returns {kernel row:
    {max_abs_err, ms, plain_ms, bound_ms, bound_by, shape}}."""
    g = torch.Generator(device=dev).manual_seed(26)
    h, rows = MESH_HEADS, MESH_ROWS
    qkv = [torch.randn((1, h, PROMPT_LEN, 64), generator=g, device=dev) for _ in range(3)]
    bf = [x.to(torch.bfloat16) for x in qkv]
    label = f"mesh rank: b=1 h={h} h_kv={h} t=s={PROMPT_LEN} causal"
    err = max(_check_flash(*qkv, True, f"{label}, f32 in"),
              _check_flash(*bf, True, f"{label}, bf16 in"))
    o, lse = flash_attention_fwd(*bf, causal=True)
    flops = 2 * 2 * h * visible_pairs(PROMPT_LEN, PROMPT_LEN, True) * 64
    out = {"flash_fwd": {"max_abs_err": err,
                         "ms": device_ms(lambda: flash_attention_fwd(*bf, causal=True)),
                         "plain_ms": device_ms(lambda: flash_attention_fwd_plain(*bf, causal=True)),
                         **bound(nbytes(*bf, o, lse), (flops, PEAK_BF16)),
                         "shape": f"(1,{h},{PROMPT_LEN},64) causal, bf16"}}

    kernels = {"decode": (decode_attention, decode_attention_plain),
               "paged_decode": (paged_decode_attention, paged_decode_attention_plain),
               "decode4": (decode_attention_int4, decode_attention_int4_plain),
               "paged4_decode": (paged4_decode_attention, paged4_decode_attention_plain)}
    q, *caches = _cache_kinds(dev, g, h, h, MESH_LENGTHS, True)
    label = (f"mesh rank: {rows} seqs, {h} q / {h} kv heads, lengths {MESH_LENGTHS}, shuffled "
             f"pages, junk pages, non-finite stale scales")
    for (name, (fn, plain)), cache in zip(kernels.items(), caches):
        out[name] = {"max_abs_err": _check_decode_kernel(name, fn, plain, q, cache, label)}
    _, spec_cache = _decode_case(dev, g, h, h, MESH_SPEC_LENGTHS, True, max_len=MESH_SPEC_LEN)
    q_spec = torch.randn((rows, h, SPEC_K + 1, 64), generator=g, device=dev)
    out["decode"]["max_abs_err"] = max(out["decode"]["max_abs_err"], _check_verify(
        "decode", q_spec, spec_cache, f"mesh rank: {rows} seqs, {h} q / {h} kv heads, max_len "
        f"{MESH_SPEC_LEN}, lengths {MESH_SPEC_LENGTHS}, non-finite stale scales"))

    length = PROMPT_LEN + NEW_TOKENS // 2  # mid-generation
    q, *caches = _cache_kinds(dev, g, h, h, [length] * rows, False)
    live_pages = rows * -(-length // PAGE)
    flops = 2 * 2 * length * rows * h * 64
    for (name, (fn, plain)), cache, per_tok, table_bytes in zip(
            kernels.items(), caches, (136, 136, 72, 72), (0, 4 * live_pages, 0, 4 * live_pages)):
        o = fn(q, cache)
        # the live tokens' K/V payloads and scales per kv head, the table
        # entries of the live pages, q, O and the lengths
        n_bytes = length * rows * h * per_tok + table_bytes + nbytes(q, o, cache[-1])
        out[name].update(ms=device_ms(lambda: fn(q, cache)),
                         plain_ms=device_ms(lambda: plain(q, cache), calls=4, replays=5),
                         **bound(n_bytes, (flops, PEAK_BF16)),
                         shape=f"{rows} seqs x {h} heads, length {length}")
    for name, r in out.items():
        log(f"[mesh] {name} at a rank's shape {r['shape']}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}); max|diff| "
            f"to plain {r['max_abs_err']:.3e}")
    return out


def phase_mesh_serving(dev, smi, gen) -> dict:
    """Phase 26: ServingEngine(mesh=) at (data=2, model=2) on phase 5's model
    and requests, 4 ranks (one a card where 4 cards are visible, over NCCL;
    else sharing the visible cards over gloo on CUDA tensors), each case
    beside the one-device engine; context_sharded_decode at context 4
    against B13 over the whole cache; the JAX package's dryrun_multichip
    serving half. Returns each case's launches summed over the ranks, by
    path, under the kernel rows' names."""
    from quantizedattention_tpu_torch.parallel.launch import RankPool
    from quantizedattention_tpu_torch.serve import mesh_jobs

    t_phase = time.perf_counter()
    local = _check_mesh_kernels(dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, BENCH_CFG.vocab_size, size=PROMPT_LEN).tolist()
               for _ in range(N_SLOTS)]
    params = init_transformer(BENCH_CFG, torch.Generator().manual_seed(0), "cpu")
    cards = torch.cuda.device_count()
    pool = RankPool(MESH_RANKS, "cuda", timeout_s=300)
    sharing = pool.backend != "nccl"
    where = (f"{MESH_RANKS} ranks sharing {min(cards, MESH_RANKS)} card(s) over gloo (CUDA "
             f"tensors)" if sharing else f"{MESH_RANKS} ranks, one a card, over NCCL")
    log(f"[mesh] ServingEngine(mesh=make_attention_mesh(data={MESH_SHAPE[0]}, "
        f"model={MESH_SHAPE[1]})): {where}; {pool.backend} chosen from {cards} visible card(s)")
    runs = {"mesh_local": local}
    try:
        refs = {}
        for label, (kw, exact) in MESH_CASES.items():
            base = {k: v for k, v in kw.items() if k not in ("spec_decode", "decode_horizon")}
            key = tuple(sorted(base.items(), key=lambda kv: kv[0]))
            timed = label == "bf16"
            if key not in refs:
                want, tps, eng = _one_device_serve(dev, params, prompts, runs=2 if timed else 1,
                                                   **base)
                refs[key] = (want, tps, eng)
            want, tps, eng = refs[key]
            outs = pool.run(mesh_jobs.serve, BENCH_CFG, MESH_SHAPE, prompts,
                            [NEW_TOKENS] * N_SLOTS, device_type="cuda", runs=2 if timed else 1,
                            profile=timed, n_slots=N_SLOTS, scheduler="native",
                            decode_horizon=kw.get("decode_horizon", HORIZON),
                            **{k: v for k, v in kw.items() if k != "decode_horizon"})
            got = outs[0]["tokens"][-1]
            if any(o["tokens"] != outs[0]["tokens"] for o in outs[1:]):
                raise AssertionError(f"[mesh] {label}: the ranks recorded different tokens")
            if not all(len(t) == NEW_TOKENS and all(0 <= x < BENCH_CFG.vocab_size for x in t)
                       for t in got):
                raise AssertionError(f"[mesh] {label}: a request's tokens are short or out of "
                                     f"vocab")
            same = sum(a == b for a, b in zip(got, want))
            equal = sum(x == y for a, b in zip(got, want) for x, y in zip(a, b))
            launches = {}
            for o in outs:
                for k, n in o["launches"].items():
                    row = MESH_KERNEL_ROW.get(k, k)
                    launches[row] = launches.get(row, 0) + n
            launches = {k: n for k, n in launches.items() if n}
            runs[f"mesh_{label}"] = launches
            log(f"[mesh] {label} {kw}: {same}/{N_SLOTS} requests and {equal}/"
                f"{N_SLOTS * NEW_TOKENS} tokens equal the one-device engine's; launches over "
                f"the ranks {launches}; stats(rank 0) "
                f"{ {k: v for k, v in outs[0]['stats'].items() if k != 'ledger'} }")
            if "flash_fwd" not in launches or not any(k in launches for k in MESH_KERNEL_ROW.values()):
                raise AssertionError(f"[mesh] {label}: the run launched {launches}")
            if exact and same != N_SLOTS:
                raise AssertionError(f"[mesh] {label}: f32-param tokens differ from the "
                                     f"one-device engine's")
            if not exact:
                for i, (t, g32, g16, top) in _first_gaps(eng, prompts, want, got,
                                                         kw.get("kv_quant")).items():
                    ulp = 2.0 ** (math.floor(math.log2(abs(top))) - 7) if top else 0.0
                    floor = max(SPEC_TIE_GAP, MESH_TIE_ULPS * ulp)
                    log(f"[mesh] {label}: request {i} first differs at token {t} (mesh "
                        f"{got[i][t]}, one device {want[i][t]}); the one-device run's top-2 "
                        f"logit gap there {g32:.4e} (f32; bf16 {g16:.4e}, top logit {top:.4f}, "
                        f"one bf16 ulp {ulp:.4e}); near-tie floor {floor:.4e}")
                    if g32 >= floor:
                        raise AssertionError(f"[mesh] {label}: tokens differ from the "
                                             f"one-device engine's away from a near-tie")
            if timed:
                prof = outs[0]["profile"]
                note = "not a scaling number: the ranks share one card" if sharing else \
                    "4 cards, one rank each"
                log(f"[mesh] bf16 on {smi}: mesh engine {outs[0]['tokens_per_s']:.1f} tokens/s "
                    f"(rank 0, wall {outs[0]['wall_s']:.3f} s; {note}) beside the one-device "
                    f"engine {tps:.1f} tokens/s, same model and requests")
                log(f"[mesh] one decode step of {prof['live_slots']} live slots on rank 0 "
                    f"({pool.backend}, torch.profiler, the ranks aligned by a host barrier): wall "
                    f"{prof['wall_ms']:.3f} ms, device {prof['device_ms']:.3f} ms, collective "
                    f"kernels {prof['collective_kernel_ms']:.4f} ms, memcpy "
                    f"{prof['memcpy_ms']:.4f} ms; all_reduce on the host "
                    f"{[(k, n, round(ms, 4)) for k, n, ms in prof['all_reduce_host']]}; top "
                    f"device {[(k, round(ms, 4), n) for k, ms, n in prof['top_device']]}")
                runs["mesh_profile"] = prof
                runs["mesh_tokens_per_s"] = (outs[0]["tokens_per_s"], tps)

        q, cache = _decode_case(dev, gen, BENCH_CFG.n_heads, BENCH_CFG.n_kv_heads,
                                CACHE_LENGTHS, True)
        whole = decode_attention(q, cache)
        ctx = pool.run(mesh_jobs.context_decode, q.cpu(), type(cache)(*(x.cpu() for x in cache)),
                       4, "cuda")
        err = max((o - whole.cpu()).abs().max().item() for o in ctx)
        log(f"[mesh] context_sharded_decode, context 4 ({BENCH_CFG.max_seq // 4} tokens a rank), "
            f"8 rows x 16 heads, lengths {CACHE_LENGTHS}: max|O - B13 over the whole cache| "
            f"{err:.3e} (tol {DECODE_TOL}); ranks equal "
            f"{all(torch.equal(o, ctx[0]) for o in ctx)}")
        if not (err <= DECODE_TOL and all(torch.isfinite(o).all() for o in ctx)
                and all(torch.equal(o, ctx[0]) for o in ctx)):
            raise AssertionError("[mesh] context_sharded_decode disagrees with B13")

        dry = pool.run(mesh_jobs.dryrun_serving, "cuda")
        n_emit = dry[0]["verify"][:, -1]
        ok = all(((d[k] >= 0) & (d[k] < 128)).all() for d in dry for k in ("decode", "quantized"))
        ok &= bool(((n_emit >= 1) & (n_emit <= 4)).all())
        ok &= all(torch.equal(d["verify"], dry[0]["verify"]) for d in dry)
        log(f"[mesh] dryrun_multichip's serving half (data={dry[0]['shape'][0]} x "
            f"model={dry[0]['shape'][1]}): sharded decode, int8 weights over the int4 cache, "
            f"sharded verify (n_emit {n_emit.tolist()}): {'ok' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError("[mesh] the dryrun_multichip serving twin failed")
    finally:
        pool.close()
    log(f"[mesh] phase 26 took {time.perf_counter() - t_phase:.1f} s")
    return runs



# --------------------------------------------------------------------------
# Sequence-parallel training (phase 27)
# --------------------------------------------------------------------------

# dryrun_multichip's factoring of 4 ranks (__graft_entry__.py:34-47): one rank
# holds TRAIN_CFG's 8 heads of 16 and 1024 of 2048 tokens; Ulysses runs on
# (data 2, model 1, context 2), where 16 heads divide the context axis
SP_SHAPE, SP_ULYSSES_SHAPE, SP_RANKS = (1, 2, 2), (2, 1, 2), 4
SP_HEADS, SP_T = TRAIN_CFG.n_heads // SP_SHAPE[1], TRAIN_CFG.max_seq // SP_SHAPE[2]
# B1-B3 at the SP paths' shard shapes with the global offsets (B-f2): (label,
# b, h, h_kv, t, s, q_offset, k_offset, timed). The all-gather launch (t_local
# queries at q_offset t_local against the gathered 2 t_local keys), the
# ring's two live steps (its diagonal, offsets equal, and a past shard),
# GQA 8 q / 2 kv heads, offsets off the 64/128 tile grid, and two cases with
# rows that see no key: kv_sharded_attention's (q_offset 0, k_offset 512:
# rows below 512 see nothing and keys from 512 on are seen by no row) and
# rows 0-76 of a live tile (k_offset 77)
SP_KERNEL_CASES = [
    ("allgather", TRAIN_BATCH, SP_HEADS, SP_HEADS, SP_T, 2 * SP_T, SP_T, 0, True),
    ("ring_diagonal", TRAIN_BATCH, SP_HEADS, SP_HEADS, SP_T, SP_T, SP_T, SP_T, True),
    ("ring_past", TRAIN_BATCH, SP_HEADS, SP_HEADS, SP_T, SP_T, SP_T, 0, True),
    ("gqa", TRAIN_BATCH, SP_HEADS, 2, SP_T, 2 * SP_T, SP_T, 0, True),
    ("unaligned", 1, 8, 2, 300, 700, 1000, 37, False),
    ("kv_sharded", 2, SP_HEADS, SP_HEADS, SP_T, SP_T, 0, 512, False),
    ("empty_in_tile", 1, 4, 4, 200, 300, 0, 77, False),
]
SP_RUNS = [  # (label, mesh shape, attention, attention_sp, steps)
    ("ring", SP_SHAPE, "bf16", "ring", 3),
    ("ring_int8", SP_SHAPE, "int8", "ring", 2),
    ("allgather", SP_SHAPE, "bf16", "allgather", 1),
    ("zigzag", SP_SHAPE, "bf16", "zigzag", 1),
    ("zigzag_int8", SP_SHAPE, "int8", "zigzag", 1),
    ("ulysses", SP_ULYSSES_SHAPE, "bf16", "ulysses", 1),
    ("ulysses_int8", SP_ULYSSES_SHAPE, "int8", "ulysses", 1),
    ("allgather_int8", SP_SHAPE, "int8", "allgather", 1),
    # the default: the strategy parallel/scaling_model.py predicts fastest
    ("auto", SP_SHAPE, "bf16", "auto", 1),
    ("auto_int8", SP_SHAPE, "int8", "auto", 1),
]
# the sharded step's first loss and gradients against the one-device
# make_train_step of the same attention kind on the same batch and params.
# bf16: the CPU tests' tolerances (tests/test_torch_train.py:286-287); the
# strategies differ from one device where B1-B3's bf16 roundings grow f32
# regrouping (the witness, `_split_batch_witness`). int8: set from the card's
# readings (PERF.md, PR 20): first losses within 7.6e-6, so 5e-5; gradients
# of the ring 6.5e-3 and Ulysses 4.8e-3, which share one device's
# quantization grid but for shard edges (2e-2), zigzag 3.59e-2, whose
# 512-token chunks sit on another grid as far from one device's int8 as that
# is from one device's bf16 (3.55e-2), so 7e-2
SP_LOSS_REL, SP_GRAD_REL_L2 = 1e-4, 3e-2
SP_INT8_LOSS_REL = 5e-5
# the int8 all-gather shares one device's quantization grid but for shard
# edges, as the ring does: the ring's limit
SP_INT8_GRAD_REL_L2 = {"ring": 2e-2, "ulysses": 2e-2, "zigzag": 7e-2, "allgather": 2e-2}
SP_PATH_KERNELS = {"bf16": ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "flash_bwd_prep"),
                   "int8": ("quant_int8", "int8_fwd", "int8_bwd_dkv", "int8_bwd_dq")}
# B5, B7 and B8 at the int8 SP paths' shapes with the global offsets: (label,
# b, h, h_kv, t, s, q_offset, k_offset, timed). The int8 all-gather launch
# (t_local queries at q_offset t_local against the gathered 2 t_local keys),
# GQA 8 q / 2 kv heads, offsets off the 64/128 tile grid, the KV-sharded
# launch (q over TRAIN_CFG's whole sequence against the last of 4 key
# shards: rows below 1536 see no key), rows 0-76 of a live tile that see no
# key, and the ring's past piece (causal, every key visible)
SP_INT8_CASES = [
    ("allgather", TRAIN_BATCH, SP_HEADS, SP_HEADS, SP_T, 2 * SP_T, SP_T, 0, True),
    ("gqa", TRAIN_BATCH, SP_HEADS, 2, SP_T, 2 * SP_T, SP_T, 0, True),
    ("unaligned", 1, 8, 2, 300, 700, 1000, 37, False),
    ("kv_sharded", TRAIN_BATCH, SP_HEADS, SP_HEADS, TRAIN_CFG.max_seq, TRAIN_CFG.max_seq // 4, 0,
     3 * TRAIN_CFG.max_seq // 4, True),
    ("empty_in_tile", 1, 4, 4, 200, 300, 0, 77, False),
    ("ring_past", TRAIN_BATCH, SP_HEADS, SP_HEADS, SP_T, SP_T, SP_T, 0, False),
]
# the int8 KV-sharded forward on 4 ranks against one device's computation of
# the same per-shard partials and lse merge: the ranks' K mean and merge sum
# in another order, so a K payload entry can land one step apart; the
# kernels' own tolerance
SP_KV_INT8_TOL = FLASH_O_TOL


def _sp_visible(t: int, s: int, q_offset: int, k_offset: int) -> torch.Tensor:
    """[t] bool: each query row sees a key (causal on global positions)."""
    return torch.arange(t) + q_offset - k_offset >= 0


def _sdpa_offsets(t: int, s: int, q_offset: int, k_offset: int) -> tuple[dict | None, str]:
    """The SDPA arguments that compute causal attention at these offsets
    without a dense mask, so that SDPA may take a fused (flash or
    memory-efficient) backend: none where every row sees every key (a past
    shard), is_causal where the offsets are equal and t = s (top-left, the
    ring's diagonal), causal_lower_right where the last query sits on the
    last key (the all-gather launch); None where only a dense mask does."""
    from torch.nn.attention.bias import causal_lower_right

    diag = q_offset - k_offset
    if diag >= s - 1:
        return {}, "no mask (every row sees every key)"
    if diag == 0 and t == s:
        return {"is_causal": True}, "is_causal=True"
    if diag == s - t:
        return {"attn_mask": causal_lower_right(t, s)}, "attn_mask=causal_lower_right(t, s)"
    return None, "a dense mask only"


def _sdpa_ms(q, k, v, do, **kw) -> tuple[float, float, list]:
    """SDPA on bf16 copies with `kw` (GQA: enable_gqa=True, K/V unrepeated):
    (forward ms, backward ms = forward + backward - forward, the forward's
    device kernels by torch.profiler, which name the backend)."""
    gqa = q.shape[1] != k.shape[1]
    qb, kb, vb = (x.to(torch.bfloat16).requires_grad_(True) for x in (q, k, v))
    dob = do.to(torch.bfloat16)

    def fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qb, kb, vb, enable_gqa=gqa, **kw)

    def fwd_bwd():
        torch.autograd.grad(F.scaled_dot_product_attention(qb, kb, vb, enable_gqa=gqa, **kw),
                            (qb, kb, vb), dob)

    for _ in range(3):
        fwd_bwd()
    f = device_ms(fwd, calls=4, replays=5)
    return f, device_ms(fwd_bwd, calls=4, replays=5) - f, sorted(device_kernels(fwd))


def _sp_case(g, dev, label, b, h, h_kv, t, s, qo, ko, timed) -> tuple[dict, dict]:
    """B1, then B2 + B3 fast on B1's O and lse, at one offset case against
    their plain versions (FLASH_O_TOL, FLASH_LSE_TOL, BWD_FAST_TOL; each
    called twice for the same bits). Rows that see no key must give O = 0 and
    lse = -inf and dQ = 0, keys no row sees dK = dV = 0, all exactly, in the
    kernels and the plain versions. Returns (each kernel's max|diff|, with
    `timed` each kernel's times beside its plain version, bound and SDPA)."""
    q, k, v, do = _qkvdo(g, dev, b, h, h_kv, t, s)
    kw = dict(causal=True, q_offset=qo, k_offset=ko)
    where = f"{label}: b={b} h={h} h_kv={h_kv} t={t} s={s} q_offset={qo} k_offset={ko}"
    o, lse = flash_attention_fwd(q, k, v, **kw)
    o2, lse2 = flash_attention_fwd(q, k, v, **kw)
    o_p, lse_p = flash_attention_fwd_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
        raise AssertionError(f"flash_fwd gave other bits on a second call at {where}")
    seen = _sp_visible(t, s, qo, ko).to(dev)
    empty = ~seen
    for name, (oo, ll) in (("kernel", (o, lse)), ("plain", (o_p, lse_p))):
        if empty.any() and not ((oo[:, :, empty] == 0).all() and (ll[:, :, empty] == -math.inf).all()):
            raise AssertionError(f"flash_fwd {name}: rows that see no key do not give O = 0 and "
                                 f"lse = -inf at {where}")
    err_o = (o - o_p)[:, :, seen].abs().max().item()
    err_l = (lse - lse_p)[:, :, seen].abs().max().item()
    log(f"[sp] flash_fwd {where}: max|dO| {err_o:.3e} (tol {FLASH_O_TOL}) max|dlse| {err_l:.3e} "
        f"(tol {FLASH_LSE_TOL}); {int(empty.sum())} rows see no key: O = 0, lse = -inf exactly")
    if not (err_o <= FLASH_O_TOL and err_l <= FLASH_LSE_TOL):
        raise AssertionError("flash_fwd kernel disagrees with its plain version at the offsets")
    ops = bwd_operands(q, k, v, o, lse, do, causal=True, fast=True, q_offset=qo, k_offset=ko)
    errs = {"flash_fwd": err_o, **_check_bwd(ops, f"[sp] {where}")}
    dk, dv = flash_bwd_dkv(ops)
    dq = flash_bwd_dq(ops)
    dk_p, dv_p = flash_bwd_dkv_plain(ops)
    dq_p = flash_bwd_dq_plain(ops)
    unseen = torch.arange(s, device=dev) + ko > t - 1 + qo  # keys no query sees
    for name, (gq, gk, gv) in (("kernel", (dq, dk, dv)), ("plain", (dq_p, dk_p, dv_p))):
        if not ((gq[:, :, empty] == 0).all() and (gk[:, unseen] == 0).all()
                and (gv[:, unseen] == 0).all()):
            raise AssertionError(f"flash_bwd {name}: rows that see no key or keys no row sees "
                                 f"have nonzero gradients at {where}")
    if empty.any() or unseen.any():
        log(f"[sp] flash_bwd {where}: dQ of the {int(empty.sum())} rows that see no key and "
            f"dK, dV of the {int(unseen.sum())} keys no row sees are 0 exactly (kernels and plain)")
    if not timed:
        return errs, {}
    kb, vb = k.to(torch.bfloat16), v.to(torch.bfloat16)  # the SP paths hand K/V in bf16
    pairs = b * h * visible_pairs(t, s, True, qo, ko)
    lib = _sp_library(q, k, v, do, t, s, qo, ko, where)
    times = {
        "flash_fwd": {"ms": device_ms(lambda: flash_attention_fwd(q, kb, vb, **kw)),
                      "plain_ms": device_ms(lambda: flash_attention_fwd_plain(q, kb, vb, **kw),
                                            calls=4, replays=5),
                      **bound(nbytes(q, kb, vb, o, lse), (2 * 2 * pairs * 64, PEAK_BF16)),
                      **lib[0]},
        "flash_bwd_dkv": {"ms": device_ms(lambda: flash_bwd_dkv(ops)),
                          "plain_ms": device_ms(lambda: flash_bwd_dkv_plain(ops), calls=4,
                                                replays=5),
                          **bound(nbytes(*ops[:6], dk, dv), (4 * 2 * pairs * 64, PEAK_BF16)),
                          **lib[1]},
        "flash_bwd_dq": {"ms": device_ms(lambda: flash_bwd_dq(ops)),
                         "plain_ms": device_ms(lambda: flash_bwd_dq_plain(ops), calls=4,
                                               replays=5),
                         **bound(nbytes(*ops[:6], dq), (3 * 2 * pairs * 64, PEAK_BF16)),
                         **lib[1]},
    }
    for name, r in times.items():
        r["shape"] = where
        log(f"[sp] {name} {where}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), sdpa {r['library_ms']:.4f} ms "
            f"({r['library_call']}), sdpa with the dense mask {r['library_mask_ms']:.4f} ms")
    return errs, times


def _sp_library(q, k, v, do, t, s, qo, ko, where) -> list:
    """SDPA in bf16 at the offsets, on a fused backend where arguments other
    than a dense mask compute the case (GQA by enable_gqa), and with the
    offsets' dense boolean mask as a second field: [the forward's fields,
    the backward's]."""
    dev = q.device
    fused, call = _sdpa_offsets(t, s, qo, ko)
    mask = (torch.arange(s, device=dev)[None, :] + ko <= torch.arange(t, device=dev)[:, None] + qo)
    mask_f, mask_b, _ = _sdpa_ms(q, k, v, do, attn_mask=mask)
    sdpa_f, sdpa_b, sdpa_kernels = (mask_f, mask_b, []) if fused is None else \
        _sdpa_ms(q, k, v, do, **fused)
    call = f"F.scaled_dot_product_attention({call}" + (
        ", enable_gqa=True" if q.shape[1] != k.shape[1] else "") + "), bf16"
    log(f"[sp] sdpa {where}: {call}: forward kernels {[x[:60] for x in sdpa_kernels]}")
    return [{"library_ms": f, "library_call": call + tail, "library_mask_ms": m}
            for f, m, tail in ((sdpa_f, mask_f, ""), (sdpa_b, mask_b, ", backward (dq, dk, dv)"))]


def _sp_int8_case(g, dev, label, b, h, h_kv, t, s, qo, ko, timed) -> tuple[dict, dict]:
    """B4, then B5 and B7 + B8 on its payloads at one offset case against
    their plain versions (FLASH_O_TOL, FLASH_LSE_TOL, INT8_BWD_TOL; each
    called twice for the same bits). Rows that see no key must give O = 0,
    lse = -inf and dQ = 0, keys no row sees dK = dV = 0, all exactly, in the
    kernels and the plain versions; a piece that sees every key gives B5's
    non-causal bits. Returns (each kernel's max|diff|, with `timed` each
    kernel's times beside its plain version, bound and SDPA)."""
    q, k, v, do = _qkvdo(g, dev, b, h, h_kv, t, s)
    k_mean = k.mean(dim=-2, keepdim=True)
    res = quantize_qkv(q, k, v, k_sub=k_mean)
    dims = (b, h, t, s, 64)
    kw = dict(causal=True, q_offset=qo, k_offset=ko)
    where = f"{label}: b={b} h={h} h_kv={h_kv} t={t} s={s} q_offset={qo} k_offset={ko}"
    o, lse = int8_attention_fwd_from_quantized(res, dims, **kw)
    o2, lse2 = int8_attention_fwd_from_quantized(res, dims, **kw)
    o_p, lse_p = int8_attention_fwd_from_quantized_plain(res, dims, **kw)
    torch.cuda.synchronize()
    if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
        raise AssertionError(f"int8_fwd gave other bits on a second call at {where}")
    seen = _sp_visible(t, s, qo, ko).to(dev)
    empty = ~seen
    for name, (oo, ll) in (("kernel", (o, lse)), ("plain", (o_p, lse_p))):
        if empty.any() and not ((oo[:, :, empty] == 0).all()
                                and (ll[:, :, empty] == -math.inf).all()):
            raise AssertionError(f"int8_fwd {name}: rows that see no key do not give O = 0 and "
                                 f"lse = -inf at {where}")
    err_o = (o - o_p)[:, :, seen].abs().max().item()
    err_l = (lse - lse_p)[:, :, seen].abs().max().item()
    log(f"[sp] int8_fwd {where}: max|dO| {err_o:.3e} (tol {FLASH_O_TOL}) max|dlse| {err_l:.3e} "
        f"(tol {FLASH_LSE_TOL}); {int(empty.sum())} rows see no key: O = 0, lse = -inf exactly")
    if not (err_o <= FLASH_O_TOL and err_l <= FLASH_LSE_TOL):
        raise AssertionError("int8_fwd kernel disagrees with its plain version at the offsets")
    if qo - ko >= s - 1:  # every row sees every key: the non-causal launch's bits
        whole = int8_attention_fwd_from_quantized(res, dims, causal=False)
        if not (torch.equal(o, whole[0]) and torch.equal(lse, whole[1])):
            raise AssertionError(f"int8_fwd at {where} differs from the non-causal launch")
        log(f"[sp] int8_fwd {where}: the same bits as the non-causal launch")
    del o2, lse2, o_p, lse_p
    ops = int8_bwd_operands(res, k_mean, o, lse, do, dims, **kw)
    dk, dv = int8_bwd_dkv(ops)
    dq = int8_bwd_dq(ops)
    again = (*int8_bwd_dkv(ops), int8_bwd_dq(ops))
    torch.cuda.synchronize()
    if not all(torch.equal(a, c) for a, c in zip((dk, dv, dq), again)):
        raise AssertionError(f"int8 backward kernels give other bits on a second call at {where}")
    del again
    dk_p, dv_p = int8_bwd_dkv_plain(ops)
    dq_p = int8_bwd_dq_plain(ops)
    err, rel = {"int8_fwd": err_o}, {}
    for name, got, want in (("dq", dq, dq_p), ("dk", dk, dk_p), ("dv", dv, dv_p)):
        if not torch.isfinite(got).all():
            raise AssertionError(f"int8 backward {name} is not finite at {where}")
        diff = (got - want).abs().max().item()
        rel[name] = diff / want.abs().max().item()
        kernel = "int8_bwd_dq" if name == "dq" else "int8_bwd_dkv"
        err[kernel] = max(err.get(kernel, 0.0), diff)
    dq4 = dq.reshape(b, h, t, 64)
    dk4, dv4 = dk.reshape(b, h_kv, s, 64), dv.reshape(b, h_kv, s, 64)
    dq4_p = dq_p.reshape(b, h, t, 64)
    dk4_p, dv4_p = dk_p.reshape(b, h_kv, s, 64), dv_p.reshape(b, h_kv, s, 64)
    unseen = torch.arange(s, device=dev) + ko > t - 1 + qo  # keys no query sees
    for name, (gq, gk, gv) in (("kernel", (dq4, dk4, dv4)), ("plain", (dq4_p, dk4_p, dv4_p))):
        if not ((gq[:, :, empty] == 0).all() and (gk[:, :, unseen] == 0).all()
                and (gv[:, :, unseen] == 0).all()):
            raise AssertionError(f"int8 backward {name}: rows that see no key or keys no row "
                                 f"sees have nonzero gradients at {where}")
    log(f"[sp] int8 backward {where}: max|diff|/max|plain| dq {rel['dq']:.3e} dk {rel['dk']:.3e} "
        f"dv {rel['dv']:.3e} (tol {INT8_BWD_TOL}), second call bit-equal; dQ of the "
        f"{int(empty.sum())} rows that see no key and dK, dV of the {int(unseen.sum())} keys no "
        f"row sees are 0 exactly (kernels and plain)")
    if max(rel.values()) > INT8_BWD_TOL:
        raise AssertionError("int8 backward kernels disagree with their plain versions at the "
                             "offsets")
    if not timed:
        return err, {}
    pairs = b * h * visible_pairs(t, s, True, qo, ko)
    prod = 2 * pairs * 64  # one product over the visible pairs
    payload = nbytes(*(x for pair in res for x in pair))
    rows_in = nbytes(ops.do, ops.lse, ops.di)
    lib = _sp_library(q, k, v, do, t, s, qo, ko, where)

    def plain_ms(fn):
        return device_ms(fn, calls=4, replays=5)

    times = {
        "int8_fwd": {"ms": device_ms(lambda: int8_attention_fwd_from_quantized(res, dims, **kw)),
                     "plain_ms": plain_ms(lambda: int8_attention_fwd_from_quantized_plain(
                         res, dims, **kw)),
                     **bound(payload + nbytes(o, lse), (prod, PEAK_INT8), (prod, PEAK_BF16)),
                     **lib[0]},
        "int8_bwd_dkv": {"ms": device_ms(lambda: int8_bwd_dkv(ops)),
                         "plain_ms": plain_ms(lambda: int8_bwd_dkv_plain(ops)),
                         **bound(payload + rows_in + nbytes(dk, dv), (prod, PEAK_INT8),
                                 (3 * prod, PEAK_BF16)), **lib[1]},
        "int8_bwd_dq": {"ms": device_ms(lambda: int8_bwd_dq(ops)),
                        "plain_ms": plain_ms(lambda: int8_bwd_dq_plain(ops)),
                        **bound(payload + rows_in + nbytes(ops.k_mean, dq), (prod, PEAK_INT8),
                                (2 * prod, PEAK_BF16)), **lib[1]},
    }
    for name, r in times.items():
        r["shape"] = where
        log(f"[sp] {name} {where}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), sdpa {r['library_ms']:.4f} ms "
            f"({r['library_call']}), sdpa with the dense mask {r['library_mask_ms']:.4f} ms")
    return err, times


def _sp_kernels(dev) -> tuple[dict, dict]:
    """Phase 27's kernel checks on card 0: every SP_KERNEL_CASES case (B1-B3)
    and SP_INT8_CASES case (B5, B7, B8). Returns (each kernel's worst
    max|diff|, {kernel: {case: times}})."""
    g = torch.Generator(device=dev).manual_seed(27)
    names = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "int8_fwd", "int8_bwd_dkv",
             "int8_bwd_dq")
    errs, times = [], {name: {} for name in names}
    for check, cases in ((_sp_case, SP_KERNEL_CASES), (_sp_int8_case, SP_INT8_CASES)):
        for label, *case in cases:
            e, tm = check(g, dev, label, *case)
            errs.append(e)
            for name, r in tm.items():
                times[name][label] = r
            torch.cuda.empty_cache()
    return {k: max(e[k] for e in errs if k in e) for k in names}, times


def _kv_sharded_int8(pool, dev) -> None:
    """kv_sharded_attention_int8 on 4 ranks (context 4) against one device's
    computation of the same thing: each K/V shard quantized with the global
    K mean, B5 at its k_offset, the partials merged by their lse."""
    from quantizedattention_tpu_torch.models import sharded_jobs

    b, h, t = TRAIN_BATCH, SP_HEADS, TRAIN_CFG.max_seq
    q, k, v, _ = _qkvdo(torch.Generator(device=dev).manual_seed(29), dev, b, h, h, t, t)
    outs = pool.run(sharded_jobs.kv_sharded, q.cpu(), k.cpu(), v.cpu(), (1, 1, SP_RANKS), True,
                    "cuda", "int8")
    n, c = SP_RANKS, t // SP_RANKS
    k_mean = torch.stack([x.mean(dim=-2, keepdim=True) for x in k.chunk(n, 2)]).sum(0) / n
    parts = []
    for i in range(n):
        ks, vs = k[:, :, i * c:(i + 1) * c], v[:, :, i * c:(i + 1) * c]
        parts.append(int8_attention_fwd_from_quantized(quantize_qkv(q, ks, vs, k_sub=k_mean),
                                                       (b, h, t, c, 64), causal=True, q_offset=0,
                                                       k_offset=i * c))
    lse = torch.stack([p[1] for p in parts])
    m = lse.amax(0)
    w = torch.where(torch.isfinite(lse), torch.exp2(lse - m), 0.0)
    want = (torch.stack([p[0] for p in parts]) * w[..., None]).sum(0) / w.sum(0)[..., None]
    ref = reference_attention(q, k, v, causal=True)
    err = max((got.to(dev) - want).abs().max().item() for got in outs)
    same = all(torch.equal(got, outs[0]) for got in outs)
    log(f"[sp] kv_sharded_attention_int8 on {n} ranks, q ({b},{h},{t},64) against K/V shards of "
        f"{c}: max|diff| to one device's partials and merge {err:.3e} (tol {SP_KV_INT8_TOL}); "
        f"every rank the same bits: {same}; max|diff| to the fp32 reference "
        f"{(outs[0].to(dev) - ref).abs().max().item():.3e}")
    if not (err <= SP_KV_INT8_TOL and same):
        raise AssertionError("kv_sharded_attention_int8 disagrees with one device's")


def _rel_l2(got: dict, ref: dict) -> dict:
    """{name: ||got - ref|| / ||ref||} over the reference's tensors."""
    return {n: ((got[n].float() - ref[n]).norm() / ref[n].norm()).item() for n in ref}


def _f32_attention(q, k, v):
    """Causal attention in f32 (SDPA; TF32 is off): the witness's reference
    for what B1-B3's bf16 roundings do to the gradient."""
    return F.scaled_dot_product_attention(q, k, v, is_causal=True)


def _split_batch_witness(params, tokens, targets, cfg, ref: dict, dev) -> None:
    """A witness for how far the sharded bf16 steps may sit from the
    one-device step when their arithmetic is the same but grouped otherwise:
    the one-device gradient from the batch in two halves (the Ulysses
    ranks' batch shards; each half's mean loss halved, the two gradients
    summed) against the whole batch's, and the whole batch's again against
    itself (run to run); the same split with f32 attention in place of
    B1-B3, and the bf16 gradient against the f32-attention one (the scale of
    the kernels' bf16 roundings). Then where the split's difference is born:
    the share of a product's elements whose f32 bits change when cuBLAS
    computes it at a shard's shape (the first q projection's rows of batch
    0-1, the Ulysses data shard, and its first 512 columns, the model shard
    of the all-gather and ring runs), the half batch's logits against the
    whole batch's rows, and B1-B3 at the half batch against the whole's."""
    half = tokens.shape[0] // 2
    names = list(ref)

    def grads(toks, tgts, attention_fn=None):
        return {n: g.cpu() for n, g in zip(names, _grads(params, toks.to(dev), tgts.to(dev), cfg,
                                                         attention_fn)[1])}

    def split(attention_fn=None):
        parts = [grads(tokens[i:i + half], targets[i:i + half], attention_fn) for i in (0, half)]
        return {n: (parts[0][n] + parts[1][n]) / 2 for n in names}

    rel_split, rel_again = _rel_l2(split(), ref), _rel_l2(grads(tokens, targets), ref)
    ref32 = grads(tokens, targets, _f32_attention)
    rel_split32, rel_bf16 = _rel_l2(split(_f32_attention), ref32), _rel_l2(ref, ref32)
    worst = max(rel_split, key=rel_split.get)
    x = params["embed"].to(dev)[tokens.to(dev)]
    w = params["layers"][0]["wq"].to(dev)
    whole = x @ w
    rows = (x[:half] @ w != whole[:half]).float().mean().item()
    cols = (x @ w[:, :512].contiguous() != whole[..., :512]).float().mean().item()
    with torch.no_grad():  # the forward: the half batch's logits against the whole's rows
        on_dev = _to(params, dev)
        logits = [transformer_forward(on_dev, tokens[:n].to(dev), cfg)[:half]
                  for n in (half, tokens.shape[0])]
        logit_share = (logits[0] != logits[1]).float().mean().item()
    # B1-B3 at the half and the whole batch on random inputs, TRAIN_CFG's heads
    g = torch.Generator(device=dev).manual_seed(28)
    q, k, v, do = _qkvdo(g, dev, tokens.shape[0], cfg.n_heads, cfg.n_kv_heads, cfg.max_seq,
                         cfg.max_seq)
    outs = []
    for n in (half, tokens.shape[0]):
        o, lse = flash_attention_fwd(q[:n], k[:n], v[:n], causal=True)
        ops = bwd_operands(q[:n], k[:n], v[:n], o, lse, do[:n], causal=True, fast=True)
        outs.append((o, *flash_bwd_dkv(ops), flash_bwd_dq(ops)))
    bh = half * cfg.n_kv_heads  # the half batch's leading rows of [b * h_kv, ...]
    kernels_equal = torch.equal(outs[0][0], outs[1][0][:half]) and all(
        torch.equal(a, b[:bh]) for a, b in zip(outs[0][1:], outs[1][1:]))
    log(f"[sp] witness (one device, bf16): the gradient from two half batches vs the whole "
        f"batch's: rel L2 max {rel_split[worst]:.3e} ({worst}), median "
        f"{statistics.median(rel_split.values()):.3e}; the whole batch's again: max "
        f"{max(rel_again.values()):.3e}; with f32 attention (SDPA) in place of B1-B3, the two "
        f"half batches vs the whole: max {max(rel_split32.values()):.3e}, median "
        f"{statistics.median(rel_split32.values()):.3e}; the bf16 gradient vs the f32-attention "
        f"one: max {max(rel_bf16.values()):.3e}, median "
        f"{statistics.median(rel_bf16.values()):.3e}; embed @ wq in f32 at a shard's shape: "
        f"{rows:.2%} of the elements differ from the whole product's (rows of batch 0-1), "
        f"{cols:.2%} (512 columns); "
        f"the half batch's logits: {logit_share:.2%} of the elements differ from the whole "
        f"batch's; B1, B2, B3 at the half batch: "
        f"{'the same bits as' if kernels_equal else 'other bits than'} at the whole batch")


def _check_auto(label, outs, cfg, shape, attention, count, per_step) -> str:
    """An attention_sp="auto" run of phase 27: every rank picked and ran the
    resolver's strategy for this mesh (resolve_attention_sp), and its
    launches a step equal the run that named that strategy on the same mesh,
    where SP_RUNS has one. Returns the strategy."""
    from quantizedattention_tpu_torch.models.sharded_train import resolve_attention_sp

    want = resolve_attention_sp(cfg, shape[1], shape[2], attention)
    got = {(o["attention_sp"], *o["ran"]) for o in outs}
    named = per_step.get((shape, attention, want))
    steps = len(outs[0]["ran"])
    log(f"[sp] {label}: the resolver's pick at mesh {shape} ({attention}) is {want!r}; the "
        f"ranks picked and ran {sorted(got)}; launches a step {count}"
        + (f", the named {want!r} run's {named}" if named else ""))
    if got != {(want,) + (want,) * steps}:
        raise AssertionError(f"[sp] {label}: the step ran {got}, not the resolver's {want!r}")
    if named is not None and {k: n / steps for k, n in count.items()} != named:
        raise AssertionError(f"[sp] {label}: launches a step differ from the named {want!r} run")
    return want


def phase_sp_training(dev, smi) -> tuple[dict, object]:
    """Phase 27: B1-B3 with the global offsets at the SP shard shapes (card
    0), then make_sharded_train_step at TRAIN_CFG's full width (f32 params,
    TRAIN_BATCH x 2048 tokens) on 4 ranks: NCCL with a card a rank where 4
    cards are visible, else sharing the card over gloo. Every run of SP_RUNS:
    the ranks' first losses equal, losses finite, every kernel of its
    attention path launched; its first loss and gradients against the
    one-device make_train_step of its attention kind; the int8 KV-sharded
    forward; then the training half of the JAX dryrun_multichip. Returns
    ({"errs", "times", "launches": {run: launches summed over the ranks}},
    the open RankPool, which phase 28 runs on and closes)."""
    from quantizedattention_tpu_torch.models import sharded_jobs
    from quantizedattention_tpu_torch.models.sharded_jobs import _flat
    from quantizedattention_tpu_torch.parallel.launch import RankPool

    t_phase = time.perf_counter()
    errs, times = _sp_kernels(dev)
    cfg = TRAIN_CFG
    rng = np.random.default_rng(27)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (TRAIN_BATCH, cfg.max_seq)))
    targets = torch.roll(tokens, -1, dims=1)
    # the one-device references: the first step's loss and gradients of each
    # attention kind, on card 0, from the params every rank draws
    # (init_transformer, seed 0, CPU); param_leaves' order is the names'
    params = init_transformer(cfg, torch.Generator().manual_seed(0), "cpu")
    refs = {}
    for kind in ("bf16", "int8"):
        loss, grads = _grads(params, tokens.to(dev), targets.to(dev),
                             dataclasses.replace(cfg, attention=kind))
        refs[kind] = (loss, {name: g.cpu() for name, g in zip(_flat(params), grads)})
    rel = _rel_l2(refs["int8"][1], refs["bf16"][1])
    log(f"[sp] one device, int8 vs bf16: first loss {refs['int8'][0]:.6f} vs "
        f"{refs['bf16'][0]:.6f}; gradients rel L2 max {max(rel.values()):.3e}, median "
        f"{statistics.median(rel.values()):.3e}")
    _split_batch_witness(params, tokens, targets, cfg, refs["bf16"][1], dev)
    del params
    torch.cuda.empty_cache()
    cards = torch.cuda.device_count()
    pool = RankPool(SP_RANKS, "cuda", timeout_s=600)
    sharing = pool.backend != "nccl"
    log(f"[sp] make_sharded_train_step at TRAIN_CFG (vocab {cfg.vocab_size}, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, {cfg.n_layers} layers, f32 params, "
        f"{TRAIN_BATCH} x {cfg.max_seq} tokens): {SP_RANKS} ranks "
        + (f"sharing {min(cards, SP_RANKS)} card(s) over gloo (CUDA tensors)" if sharing else
           "one a card over NCCL") + f"; {pool.backend} chosen from {cards} visible card(s)")
    launches, per_step = {}, {}
    try:
        for label, shape, attention, sp, steps in SP_RUNS:
            outs = pool.run(sharded_jobs.train, cfg, shape, None, tokens, targets, steps,
                            attention, sp, "cuda", profile=label == "ring")
            losses = [o["losses"] for o in outs]
            if any(x[0] != losses[0][0] for x in losses) or not np.isfinite(losses).all():
                raise AssertionError(f"[sp] {label}: first losses differ over the ranks or are "
                                     f"not finite: {losses}")
            count = {k: sum(o["launches"][k] for o in outs) for k in outs[0]["launches"]}
            count = {k: n for k, n in count.items() if n}
            launches[f"train_sp_{label}"] = count
            missing = [k for k in SP_PATH_KERNELS[attention] if not count.get(k)]
            if missing:
                raise AssertionError(f"[sp] {label}: the run launched {count}, none of {missing}")
            if sp == "auto":
                sp = _check_auto(label, outs, cfg, shape, attention, count, per_step)
            else:
                per_step[shape, attention, sp] = {k: n / steps for k, n in count.items()}
            step_ms = outs[0]["step_ms"]
            note = "ranks share one card: not a scaling number" if sharing else "4 cards"
            log(f"[sp] {label} ({attention}, attention_sp={sp!r}, mesh {shape}) on {smi}: losses "
                f"{[round(x, 5) for x in losses[0]]}, every rank's first loss equal; step ms "
                f"(rank 0, wall, synchronised; the first includes set-up) "
                f"{[round(x, 1) for x in step_ms]} ({note}); launches over the ranks {count}")
            ref_loss, ref = refs[attention]
            loss_tol, grad_tol = ((SP_LOSS_REL, SP_GRAD_REL_L2) if attention == "bf16" else
                                  (SP_INT8_LOSS_REL, SP_INT8_GRAD_REL_L2[sp]))
            rel = _rel_l2(outs[0]["grads"], ref)
            loss_rel = abs(losses[0][0] - ref_loss) / abs(ref_loss)
            worst = max(rel, key=rel.get)
            log(f"[sp] {label}: first loss {losses[0][0]:.6f} vs one device ({attention}) "
                f"{ref_loss:.6f} (rel {loss_rel:.2e}, tol {loss_tol}); gradients rel L2 max "
                f"{rel[worst]:.3e} ({worst}), median {statistics.median(rel.values()):.3e} "
                f"over {len(rel)} tensors (tol {grad_tol})")
            if attention == "int8":
                rel16 = _rel_l2(outs[0]["grads"], refs["bf16"][1])
                log(f"[sp] {label}: gradients vs one device (bf16): rel L2 max "
                    f"{max(rel16.values()):.3e}, median {statistics.median(rel16.values()):.3e}")
            if not (loss_rel <= loss_tol and rel[worst] <= grad_tol):
                raise AssertionError(f"[sp] {label}: the sharded step's loss or gradients "
                                     f"differ from the one-device step's")
            if outs[0].get("profile"):
                prof = outs[0]["profile"]
                log(f"[sp] {label}: one profiled step on rank 0 ({pool.backend}): wall "
                    f"{prof['wall_ms']:.1f} ms, device {prof['device_ms']:.1f} ms, busy "
                    f"{prof['busy_share']:.1%}; top device "
                    f"{[(k, round(ms, 3), n) for k, ms, n in prof['top_device']]}")
                launches[f"train_sp_{label}_profile"] = prof
        _kv_sharded_int8(pool, dev)
        dry = pool.run(sharded_jobs.dryrun_training, "cuda")
        vals = [v for d in dry for k, v in d.items() if k != "shape"]
        ok = np.isfinite(vals).all() and all(d == dry[0] for d in dry)
        log(f"[sp] dryrun_multichip's training half (mesh {dry[0]['shape']}): "
            f"{ {k: round(v, 4) for k, v in dry[0].items() if k != 'shape'} }: "
            f"{'ok' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError("[sp] the dryrun_multichip training twin failed")
    except BaseException:
        pool.close()
        raise
    log(f"[sp] phase 27 took {time.perf_counter() - t_phase:.1f} s")
    return {"errs": errs, "times": times, "launches": launches}, pool


# --------------------------------------------------------------------------
# Sequence-parallel rCM distillation (phase 28)
# --------------------------------------------------------------------------

# the context axis over the 4 ranks: each holds 1024 of DIT_CFG's 4096 tokens
SP_RCM_SHAPE, SP_RCM_STEPS = (1, 1, SP_RANKS), 2
# the first loss against the one-device step's: the JAX test's bound
# (tests/test_models.py:183); the sharded prepass runs the bf16 ring where
# the one-device step runs B1 fp32
SP_RCM_LOSS_REL = 5e-3
# a step launches each of these once a layer and live ring step on every
# rank (the prepass's bf16 ring: B1; the pair pass: B9 and its prep; its
# backward: B11 + B12 on one shared prep), and nothing else it counts
SP_RCM_KERNELS = ("flash_fwd", "jvp_fwd", "jvp_fwd_prep", "jvp_bwd_dkv", "jvp_bwd_dq",
                  "jvp_bwd_prep")


def phase_sp_rcm(dev, smi, pool) -> dict:
    """Phase 28: make_dit_rcm_step(mesh=) at DIT_CFG's full width on
    SP_RCM_SHAPE, SP_RCM_STEPS steps on phase 27's ranks, against the
    one-device step on card 0 from the same params and batch. Returns
    {"launches": {"dit_rcm_sp": launches summed over the ranks}, ...}."""
    from quantizedattention_tpu_torch.models import sharded_jobs

    t_phase = time.perf_counter()
    cfg = DIT_CFG
    params = _dit_params(dev, cfg, seed=28)
    gen = torch.Generator(device=dev).manual_seed(28)
    x = torch.randn((DIT_BATCH, cfg.seq_len, cfg.d_model), generator=gen, device=dev)
    t = torch.rand((DIT_BATCH,), generator=gen, device=dev)
    one = _dit_copy(params, dev)
    _, step = make_dit_rcm_step(cfg, one, fast=True)
    loss_one = step(x, t).item()
    grads_one = [p.grad.detach().cpu() for p in dit_param_leaves(one)]
    del one, step
    torch.cuda.empty_cache()
    host = {k: params[k].detach().cpu() for k in ("t_mlp1", "t_mlp2", "out")}
    host["layers"] = [{k: w.detach().cpu() for k, w in layer.items()} for layer in params["layers"]]
    outs = pool.run(sharded_jobs.rcm, cfg, SP_RCM_SHAPE, host, x.cpu(), t.cpu(), SP_RCM_STEPS,
                    True, "cuda")
    losses = [o["losses"] for o in outs]
    if any(x_ != losses[0] for x_ in losses) or not np.isfinite(losses).all():
        raise AssertionError(f"[rcm] the ranks' losses differ or are not finite: {losses}")
    loss_rel = abs(losses[0][0] - loss_one) / abs(loss_one)
    names = ["t_mlp1", "t_mlp2", "out"] + [f"layers.{i}.{k}" for i in range(cfg.n_layers)
                                           for k in ("ada", "wq", "wk", "wv", "wo", "w1", "w2")]
    rel = {n: ((g - w).norm() / w.norm()).item() for n, g, w in zip(names, outs[0]["grads"],
                                                                    grads_one)}
    worst = max(rel, key=rel.get)
    count = {k: sum(o["launches"][k] for o in outs) for k in outs[0]["launches"]}
    count = {k: n for k, n in count.items() if n}
    per_step = cfg.n_layers * SP_RCM_SHAPE[2] * SP_RANKS * SP_RCM_STEPS
    want = {k: per_step for k in SP_RCM_KERNELS}
    sharing = pool.backend != "nccl"
    log(f"[rcm] make_dit_rcm_step(mesh=) at DIT_CFG (d_model {cfg.d_model}, {cfg.n_heads} x "
        f"{cfg.head_dim} heads, {cfg.n_layers} layers, {DIT_BATCH} x {cfg.seq_len} tokens, fast) "
        f"on mesh {SP_RCM_SHAPE}, {SP_RANKS} ranks "
        + ("sharing the card over gloo" if sharing else "one a card over NCCL")
        + f", {smi}: losses {[round(v, 6) for v in losses[0]]}, every rank's equal; step ms "
        f"(rank 0, wall, synchronised; the first includes set-up) "
        f"{[round(v, 1) for v in outs[0]['step_ms']]}; launches over the ranks {count}")
    log(f"[rcm] first loss {losses[0][0]:.6f} vs one device {loss_one:.6f} (rel {loss_rel:.2e}, "
        f"tol {SP_RCM_LOSS_REL}); gradients vs one device: rel L2 max {rel[worst]:.3e} "
        f"({worst}), median {statistics.median(rel.values()):.3e} over {len(rel)} tensors")
    if count != want:
        raise AssertionError(f"[rcm] the sharded steps launched {count}, want {want}")
    if not loss_rel <= SP_RCM_LOSS_REL:
        raise AssertionError("[rcm] the sharded rCM loss differs from the one-device step's")
    log(f"[rcm] phase 28 took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": {"dit_rcm_sp": count}, "loss_rel": loss_rel, "grad_rel_l2": rel,
            "step_ms": outs[0]["step_ms"]}


# --------------------------------------------------------------------------
# Pipeline-parallel training, checkpoint and failure detection (phase 29)
# --------------------------------------------------------------------------

# GPipe at TRAIN_CFG: one block a stage over the 4 ranks, 4 microbatches of
# one sequence; 3 bf16 steps (the median step printed), 1 int8 step
PIPE_MICRO, PIPE_STEPS = 4, 3
# launches over the ranks a step, in units of M L (models/pipeline.py): the
# forward and the remat recompute run B1 (int8: B4 and B5) once each a block
# and microbatch; the backward runs B2, B3 and fast mode's prep (B7, B8) once
PIPE_KERNELS = {"bf16": {"flash_fwd": 2, "flash_bwd_dkv": 1, "flash_bwd_dq": 1,
                         "flash_bwd_prep": 1},
                "int8": {"quant_int8": 2, "int8_fwd": 2, "int8_bwd_dkv": 1, "int8_bwd_dq": 1}}
# the resumed step 2 against the uninterrupted one: the JAX package's bound
# (tests/test_utils.py:98)
PIPE_RESUME_TOL = 1e-6
# StepGuard on the card: normal steps enqueue GUARD_CYCLES of torch.cuda._sleep
# (a few ms), the stalled one GUARD_STALL x as many, past GUARD_FACTOR
GUARD_CYCLES, GUARD_STALL, GUARD_FACTOR = 10_000_000, 40, 10.0


def _pipe_run(pool, label, cfg, tokens, targets, steps, ref, resume_dir) -> tuple[dict, list]:
    """One make_pipeline_train_step run on the pool's ranks against the
    one-device step's (loss, gradients) `ref`; returns (its launches over
    the ranks, the ranks' outputs)."""
    from quantizedattention_tpu_torch.models import sharded_jobs

    outs = pool.run(sharded_jobs.pipeline_train, cfg, None, tokens, targets, PIPE_MICRO, steps,
                    "cuda", True, resume_dir, profile=cfg.attention == "bf16")
    losses = [o["losses"] for o in outs]
    if any(x != losses[0] for x in losses) or not np.isfinite(losses).all():
        raise AssertionError(f"[pipe] {label}: the ranks' losses differ or are not finite: "
                             f"{losses}")
    if any(o["replicated"] != outs[0]["replicated"] for o in outs):
        raise AssertionError(f"[pipe] {label}: the replicated leaves differ over the ranks")
    count = {k: sum(o["launches"][k] for o in outs) for k in outs[0]["launches"]}
    per_step = cfg.n_layers * PIPE_MICRO * steps
    want = {k: PIPE_KERNELS[cfg.attention].get(k, 0) * per_step for k in count}
    count = {k: n for k, n in count.items() if n}
    grads = {}
    for o in reversed(outs):  # the replicated leaves' gradients from rank 0
        grads.update(o["grads"])
    ref_loss, ref_grads = ref
    rel = _rel_l2(grads, ref_grads)
    worst = max(rel, key=rel.get)
    loss_rel = abs(losses[0][0] - ref_loss) / abs(ref_loss)
    loss_tol, grad_tol = ((SP_LOSS_REL, SP_GRAD_REL_L2) if cfg.attention == "bf16" else
                          (SP_INT8_LOSS_REL, SP_INT8_GRAD_REL_L2["ring"]))
    step_ms = outs[0]["step_ms"]
    note = "ranks share one card: not a scaling number" if pool.backend != "nccl" else "4 cards"
    log(f"[pipe] {label} ({cfg.attention}, {cfg.n_layers} layers over {pool.world_size} stages, "
        f"{PIPE_MICRO} microbatches of {TRAIN_BATCH // PIPE_MICRO} x {cfg.max_seq}) over "
        f"{pool.backend}: losses {[round(x, 5) for x in losses[0]]}, every rank's equal, the "
        f"replicated leaves equal on every rank; step ms (rank 0, wall, synchronised; the first "
        f"includes set-up) {[round(x, 1) for x in step_ms]}, median "
        f"{statistics.median(step_ms):.1f} ({note}); launches over the ranks {count}")
    log(f"[pipe] {label}: first loss {losses[0][0]:.6f} vs one device ({cfg.attention}) "
        f"{ref_loss:.6f} (rel {loss_rel:.2e}, tol {loss_tol}); gradients rel L2 max "
        f"{rel[worst]:.3e} ({worst}), median {statistics.median(rel.values()):.3e} over "
        f"{len(rel)} tensors (tol {grad_tol})")
    prof = outs[0].get("profile")
    if prof:
        log(f"[pipe] {label}: one profiled step on rank 0 ({pool.backend}): wall "
            f"{prof['wall_ms']:.1f} ms, device {prof['device_ms']:.1f} ms, busy "
            f"{prof['busy_share']:.1%}; top device "
            f"{[(k, round(ms, 3), n) for k, ms, n in prof['top_device']]}")
    if {k: n for k, n in want.items() if n} != count:
        raise AssertionError(f"[pipe] {label}: launched {count} over {steps} step(s), want "
                             f"{ {k: n for k, n in want.items() if n} }")
    if not (loss_rel <= loss_tol and rel[worst] <= grad_tol):
        raise AssertionError(f"[pipe] {label}: the pipeline's loss or gradients differ from the "
                             f"one-device step's")
    return count, outs


def _failure_checks(pool) -> dict:
    """hosts_alive over the pool's ranks, device_heartbeat and a Watchdog on
    card 0, and a StepGuard that must flag a step whose device work
    (torch.cuda._sleep) crosses its factor while its call returns at once,
    and none of the normal steps before it."""
    alive = pool.run(hosts_alive, 60.0)
    beat = device_heartbeat()
    with Watchdog(device_heartbeat, interval_s=0.05, timeout_s=30.0) as wd:
        time.sleep(0.5)
    enqueue = []

    def step(cycles):
        t0 = time.perf_counter()
        torch.cuda._sleep(cycles)
        enqueue.append(time.perf_counter() - t0)

    guard = StepGuard(step, stall_factor=GUARD_FACTOR, warmup_steps=3)
    for _ in range(5):
        guard(GUARD_CYCLES)
    normal_stalls = len(guard.stalls)
    guard(GUARD_CYCLES * GUARD_STALL)
    med = statistics.median(guard.durations[:5])
    log(f"[failure] hosts_alive over the pool's ranks: {alive}; device_heartbeat on card 0 "
        f"{beat * 1e3:.3f} ms; Watchdog(device_heartbeat) {wd.probes_ok} probes, "
        f"{len(wd.failures)} failures, last {wd.last_latency_s * 1e3:.3f} ms; StepGuard: normal "
        f"steps median {med * 1e3:.2f} ms ({normal_stalls} flagged), the _sleep step "
        f"{guard.durations[-1] * 1e3:.2f} ms with its call returning in {enqueue[-1] * 1e3:.3f} "
        f"ms: {len(guard.stalls) - normal_stalls} flagged "
        f"({guard.stalls[-1].detail if guard.stalls else 'no stall'})")
    if alive != [pool.world_size] * pool.world_size:
        raise AssertionError(f"[failure] hosts_alive gave {alive}")
    if wd.failures or wd.probes_ok < 3:
        raise AssertionError(f"[failure] the watchdog failed: {wd.failures}, {wd.probes_ok} probes")
    if normal_stalls or len(guard.stalls) != 1 or enqueue[-1] * GUARD_FACTOR > guard.durations[-1]:
        raise AssertionError("[failure] StepGuard missed the device stall or flagged a normal "
                             "step, or the stalled call did not return before its work ended")
    return {"hosts_alive": alive, "heartbeat_ms": beat * 1e3, "stall_ms": guard.durations[-1] * 1e3,
            "normal_ms": med * 1e3}


def phase_pipeline(dev, smi, pool) -> dict:
    """Phase 29: B1 and B2 + B3 at the pipeline's microbatch shape (1, 16,
    2048, 64) causal against their plain versions, timed beside their
    bounds and SDPA (is_causal); then make_pipeline_train_step at
    TRAIN_CFG's full width on phase 27's ranks as a 4-stage pipe mesh (one
    block a stage, PIPE_MICRO microbatches), bf16 PIPE_STEPS steps with a
    checkpoint after step 1 that fresh params and a fresh optimizer resume
    from, and int8 1 step: every rank's loss equal, the first loss and
    gradients against the one-device step of its attention kind (phase
    27's SP bounds), launches exactly PIPE_KERNELS a step; then the failure
    detectors (`_failure_checks`). Returns {"launches", "errs", "times",
    ...}."""
    from quantizedattention_tpu_torch.models.sharded_jobs import _flat

    t_phase = time.perf_counter()
    cfg = TRAIN_CFG
    errs, times = _sp_case(torch.Generator(device=dev).manual_seed(29), dev, "pipe_microbatch",
                           TRAIN_BATCH // PIPE_MICRO, cfg.n_heads, cfg.n_kv_heads, cfg.max_seq,
                           cfg.max_seq, 0, 0, True)
    rng = np.random.default_rng(29)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (TRAIN_BATCH, cfg.max_seq)))
    targets = torch.roll(tokens, -1, dims=1)
    # the one-device references from the params every rank draws
    # (init_transformer, seed 0, CPU); param_leaves' order is the names'
    params = init_transformer(cfg, torch.Generator().manual_seed(0), "cpu")
    refs = {}
    for kind in ("bf16", "int8"):
        loss, grads = _grads(params, tokens.to(dev), targets.to(dev),
                             dataclasses.replace(cfg, attention=kind))
        refs[kind] = (loss, {name: g.cpu() for name, g in zip(_flat(params), grads)})
    del params
    torch.cuda.empty_cache()
    ckpt = tempfile.mkdtemp(prefix="qattn_pipe_ckpt_")
    try:
        bf16, outs = _pipe_run(pool, "train_pipe", cfg, tokens, targets, PIPE_STEPS, refs["bf16"],
                               ckpt)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    resumed = [o["resumed_loss"] for o in outs]
    ref2 = outs[0]["losses"][1]
    bits = all(r == ref2 for r in resumed)
    log(f"[pipe] checkpoint after step 1 (save_checkpoint, DCP, every stage's params and AdamW "
        f"state), restored into fresh params and a fresh optimizer: step 2 {resumed[0]:.8f} vs "
        f"the uninterrupted {ref2:.8f} (|diff| {abs(resumed[0] - ref2):.2e}, tol "
        f"{PIPE_RESUME_TOL}; {'bit-equal' if bits else 'not bit-equal'}); restored state equal "
        f"to the saved one on every rank: {all(o['restored_equal'] for o in outs)}")
    if not (all(o["restored_equal"] for o in outs)
            and all(abs(r - ref2) <= PIPE_RESUME_TOL for r in resumed)):
        raise AssertionError("[pipe] the resumed pipeline step differs from the uninterrupted one")
    int8, _ = _pipe_run(pool, "train_pipe_int8", dataclasses.replace(cfg, attention="int8"),
                        tokens, targets, 1, refs["int8"], None)
    failure = _failure_checks(pool)
    log(f"[pipe] phase 29 took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": {"train_pipe": bf16, "train_pipe_int8": int8},
            "errs": errs, "times": times, "step_ms": outs[0]["step_ms"],
            "profile": outs[0].get("profile"),
            "resume_bit_equal": bits, "failure": failure}


# --------------------------------------------------------------------------
# Phase 30: head dim 128 (B1 bf16, fast B2/B3 and B13; B4-B8 and B14; B15/B16,
# B1 fp32 and fast B9, B11 and B12)
# --------------------------------------------------------------------------

HEAD128 = 128
# BASELINE config 2's second head dim: (b, h, t, d), causal, fwd + bwd
CONFIG2_128 = (4, 16, 2048, HEAD128)
# config 2's oracle criteria (tests/test_baseline_configs.py:30-49): mismatch
# rates at atol 1e-2 against the fp32 oracle
CONFIG2_O_RATE, CONFIG2_GRAD_RATE = 5e-5, 1.2e-4
# training at full width: 16 heads x 128 = d_model 2048; its attention is
# exactly config 2's (4, 16, 2048, 128)
TRAIN128_CFG = TransformerConfig(vocab_size=8192, d_model=2048, n_heads=16, n_kv_heads=16,
                                 head_dim=HEAD128, n_layers=4, max_seq=2048)
# serving at full width with GQA rep 4, BENCH_CFG's traffic
SERVE128_CFG = TransformerConfig(vocab_size=8192, d_model=2048, n_heads=16, n_kv_heads=4,
                                 head_dim=HEAD128, n_layers=4, max_seq=1280)
# the kernels' tile edges at 128: B1 walks 64-key tiles through 3 stages, B2
# 128-key blocks over 64-row q tiles and B3 128-row blocks over 64-key tiles
# through 4 stages. t and s off a multiple of 128 (and of 64), causal t < s
# and t > s, rep 3 and 5, GQA rep 4, rep 128 (one position a block), one
# token, and more key tiles than stages, causal and not
HEAD128_CASES = [(1, 4, 4, 200, 330, True), (1, 4, 4, 330, 200, True), (1, 6, 2, 300, 300, True),
                 (1, 10, 2, 77, 201, False), (1, 16, 4, 300, 300, True),
                 (1, 128, 1, 40, 300, True), (1, 2, 2, 1, 1, True), (1, 3, 1, 1, 1, True),
                 (1, 2, 2, 1280, 1280, False)]


def _head128_kernels(dev) -> dict:
    """B1 bf16, fast B2/B3 and B13 at head dim 128 against their plain
    versions at the tolerances of their head-dim-64 phases (3, 6, 4 and 23),
    each called twice for the same bits; B1's f32 and bf16 paths and its
    [b, t, h, d] views as phase 3 holds them, the backward's prep and strided
    call as phase 6's. Returns each kernel's max|diff|."""
    gen = torch.Generator(device=dev).manual_seed(30)
    err = {"flash_fwd": 0.0, "flash_bwd_dkv": 0.0, "flash_bwd_dq": 0.0, "decode": 0.0}
    d_rel = 0.0
    for b, h, h_kv, t, s, causal in HEAD128_CASES:
        label = f"d=128 b={b} h={h} h_kv={h_kv} t={t} s={s} causal={causal}"
        q, k, v, do = _qkvdo(gen, dev, b, h, h_kv, t, s, HEAD128)
        bf = [x.to(torch.bfloat16) for x in (q, k, v)]
        err["flash_fwd"] = max(err["flash_fwd"], _check_flash(q, k, v, causal, f"{label}, f32 in"),
                               _check_flash(*bf, causal, f"{label}, bf16 in"))
        o, lse = flash_attention_fwd(*bf, causal=causal)
        o_f, lse_f = flash_attention_fwd(*(x.float() for x in bf), causal=causal)
        o_t, lse_t = flash_attention_fwd(*_strided(*bf), causal=causal)
        kb, vb = kv_to_bf16(*_strided(k, v))
        torch.cuda.synchronize()
        if not (torch.equal(o, o_f) and torch.equal(lse, lse_f) and torch.equal(o, o_t)
                and torch.equal(lse, lse_t)):
            raise AssertionError(f"flash_fwd: the f32 path or [b, t, h, d] views differ from "
                                 f"the bf16 call at {label}")
        if not (torch.equal(kb, bf[1]) and torch.equal(vb, bf[2])):
            raise AssertionError(f"kv_to_bf16 differs from .to(bfloat16) at {label}")
        (fast,), d = _bwd_case(q, k, v, do, causal, label, modes=(True,))
        err.update({name: max(err[name], e) for name, e in fast.items()})
        d_rel = max(d_rel, d)
    log(f"[head128] backward prep launch: q_s, dO_s, lse, K and V byte-equal to the plain prep "
        f"at every case; D max|diff|/max|D| {d_rel:.3e} (tol {PREP_D_TOL})")
    # B13: phase 4's lengths with non-finite stale scales, 16/16 and 16/4
    # heads; phase 23's verify staircase at spec 5 (and 2), rows bit-equal to
    # their spec = 1 launches
    for n_q, n_kv in ((16, 16), (16, 4)):
        q, cache = _decode_case(dev, gen, n_q, n_kv, CACHE_LENGTHS, stale=True, d=HEAD128)
        o, lse = decode_attention(q, cache, return_lse=True)
        o2, lse2 = decode_attention(q, cache, return_lse=True)
        torch.cuda.synchronize()
        o_p, lse_p = decode_attention_plain(q, cache, return_lse=True)
        live = cache.length > 0
        e_o = (o - o_p).abs().max().item()
        e_l = (lse[live] - lse_p[live]).abs().max().item()
        same = torch.equal(o, o2) and torch.equal(lse, lse2)
        empty_ok = bool((o[~live] == 0).all() and torch.isneginf(lse[~live]).all())
        log(f"[head128] decode d=128, 8 slots, {n_q} q / {n_kv} kv heads, lengths "
            f"{CACHE_LENGTHS}, non-finite stale scales: max|dO|={e_o:.3e} max|dlse|={e_l:.3e} "
            f"(tol {DECODE_TOL}) empty_rows_ok={empty_ok} second call same bits={same}")
        if not (torch.isfinite(o).all() and e_o <= DECODE_TOL and e_l <= DECODE_TOL
                and empty_ok and same):
            raise AssertionError("decode (B13) at head dim 128 disagrees with its plain version")
        err["decode"] = max(err["decode"], e_o)
        _, vcache = _decode_case(dev, gen, n_q, n_kv, SPEC_LENGTHS, stale=True, d=HEAD128)
        for spec in SPECS:
            qv = torch.randn((len(SPEC_LENGTHS), n_q, spec, HEAD128), generator=gen, device=dev)
            err["decode"] = max(err["decode"], _check_verify(
                "decode", qv, vcache, f"d=128, 8 seqs, {n_q} q / {n_kv} kv heads, lengths "
                f"{SPEC_LENGTHS}, non-finite stale scales"))
    return err


def _head128_oracle(dev) -> None:
    """BASELINE config 2 at head dim 128, causal: flash_attention_bf16 (fast
    backward) against the fp32 oracle by the JAX package's criteria for it."""
    b, h, t, d = CONFIG2_128
    q, k, v, do = _qkvdo(torch.Generator(device=dev).manual_seed(31), dev, b, h, h, t, t, d)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o = flash_attention_bf16(*leaves, causal=True)
    got = torch.autograd.grad(o, leaves, do)
    with torch.no_grad():
        rep = mismatch_report("config2 d=128 O", o.detach(), reference_attention(q, k, v, True))
    reps = [mismatch_report(n, g, w) for n, g, w in zip(
        ("dq", "dk", "dv"), got, reference_attention_vjp(q, k, v, do, causal=True))]
    log(f"[head128] BASELINE config 2 {CONFIG2_128} causal vs the fp32 oracle: {rep} (rate limit "
        f"{CONFIG2_O_RATE}); " + "; ".join(map(str, reps)) + f" (rate limit {CONFIG2_GRAD_RATE})")
    if rep.mismatch_rate > CONFIG2_O_RATE or max(r.mismatch_rate for r in reps) > \
            CONFIG2_GRAD_RATE:
        raise AssertionError("BASELINE config 2 at head dim 128 misses the JAX package's criteria")


def _head128_timing(dev) -> dict:
    """At config 2's shape, causal, on f32 inputs as the model hands them in
    (phase 7 at 128): B1 against its plain version; device time of B1 (its
    f32 call split into the K/V prep launch and the kernel, and the call on
    bf16 inputs), B2 and B3 beside their plain versions, bounds and SDPA's
    fused bf16 forward and backward; the whole fast backward call on the
    model's [b, t, h, d] views with its prep; B2 + B3 at GQA rep 4; B13 at
    the serving decode shape (8 slots x 16 q / 4 kv heads, length 304 of
    1280) and at capacity. Returns {kernel: times}."""
    b, h, t, d = CONFIG2_128
    gen = torch.Generator(device=dev).manual_seed(32)
    q, k, v, do = _qkvdo(gen, dev, b, h, h, t, t, d)
    o, lse = flash_attention_fwd(q, k, v, causal=True)
    torch.cuda.synchronize()
    o_p, lse_p = flash_attention_fwd_plain(q, k, v, causal=True)
    e_o, e_l = (o - o_p).abs().max().item(), (lse - lse_p).abs().max().item()
    log(f"[head128] flash_fwd {CONFIG2_128} causal, f32 in: max|dO|={e_o:.3e} (tol "
        f"{FLASH_O_TOL}) max|dlse|={e_l:.3e} (tol {FLASH_LSE_TOL})")
    if not (e_o <= FLASH_O_TOL and e_l <= FLASH_LSE_TOL):
        raise AssertionError("flash_fwd at head dim 128 disagrees with its plain version")
    del o_p, lse_p
    fast = bwd_operands(q, k, v, o, lse, do, causal=True, fast=True)
    err = _check_bwd(fast, f"{CONFIG2_128} causal")
    dk, dv = flash_bwd_dkv(fast)
    dq = flash_bwd_dq(fast)
    pairs = b * h * visible_pairs(t, t, True)
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    k_b, v_b = kv_to_bf16(k, v)
    sdpa_bwd = _sdpa_bwd_ms(q, k, v, do)
    out = {
        "flash_fwd": {
            "ms": device_ms(lambda: flash_attention_fwd(q, k, v, causal=True)),
            "prep_ms": device_ms(lambda: kv_to_bf16(k, v)),
            "kernel_ms": device_ms(lambda: flash_attention_fwd(q, k_b, v_b, causal=True)),
            "bf16_in_ms": device_ms(lambda: flash_attention_fwd(qb, kb, vb, causal=True)),
            "plain_ms": device_ms(lambda: flash_attention_fwd_plain(q, k, v, True), calls=4,
                                  replays=5),
            **bound(nbytes(q, k, v, o, lse), (2 * 2 * pairs * d, PEAK_BF16)),
            "library_ms": device_ms(lambda: F.scaled_dot_product_attention(qb, kb, vb,
                                                                           is_causal=True))},
        "flash_bwd_dkv": {
            "ms": device_ms(lambda: flash_bwd_dkv(fast)),
            "plain_ms": device_ms(lambda: flash_bwd_dkv_plain(fast), calls=4, replays=5),
            **bound(nbytes(*fast[:6], dk, dv), (4 * 2 * pairs * d, PEAK_BF16)),
            "library_ms": sdpa_bwd},
        "flash_bwd_dq": {
            "ms": device_ms(lambda: flash_bwd_dq(fast)),
            "plain_ms": device_ms(lambda: flash_bwd_dq_plain(fast), calls=4, replays=5),
            **bound(nbytes(*fast[:6], dq), (3 * 2 * pairs * d, PEAK_BF16)),
            "library_ms": sdpa_bwd},
    }
    for name in ("flash_bwd_dkv", "flash_bwd_dq"):
        out[name]["library_call"] = ("backward of F.scaled_dot_product_attention(is_causal=True), "
                                     "bf16: dq, dk, dv together")
    out["flash_fwd"]["library_call"] = "F.scaled_dot_product_attention(is_causal=True), bf16"
    fwd = out["flash_fwd"]
    log(f"[head128] flash_fwd {CONFIG2_128} causal, f32 in: call {fwd['ms']:.4f} ms = K/V prep "
        f"launch {fwd['prep_ms']:.4f} ms + kernel {fwd['kernel_ms']:.4f} ms; bf16 in (no prep "
        f"launch) {fwd['bf16_in_ms']:.4f} ms")
    del fast, dk, dv, dq, k_b, v_b, qb, kb, vb
    call, call_err = _bwd_call_times(q, k, v, o, lse, do)
    out["flash_bwd_dkv"].update(call)
    err.update({name: max(err[name], e) for name, e in call_err.items()})
    gqa = _bwd_gqa_times(*_qkvdo(gen, dev, 2, 16, 4, t, t, d))
    for name in ("flash_bwd_dkv", "flash_bwd_dq"):
        out[name].update(gqa[name])
    for name, r in out.items():
        log(f"[head128] {name} {CONFIG2_128} causal: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"{r['ms'] / r['bound_ms']:.2f}x; sdpa {r['library_ms']:.4f} ms")
    # B13 at the serving decode shape of SERVE128_CFG and at capacity
    length = PROMPT_LEN + NEW_TOKENS // 2
    q, cache = _decode_case(dev, gen, 16, 4, [length] * N_SLOTS, stale=False, d=d)
    o = decode_attention(q, cache)
    live = int(cache.length.sum()) * cache.k_i8.shape[1]
    dec = {"ms": device_ms(lambda: decode_attention(q, cache)),
           "plain_ms": device_ms(lambda: decode_attention_plain(q, cache)),
           **bound(live * 2 * (d + 4) + nbytes(q, o, cache.length),
                   (2 * 2 * int(cache.length.sum()) * q.shape[1] * d, PEAK_BF16)),
           "library_ms": None}
    log(f"[head128] decode d=128, 8 slots x 16 q / 4 kv heads, length {length} of "
        f"{BENCH_CFG.max_seq}: kernel {dec['ms']:.4f} ms, plain {dec['plain_ms']:.4f} ms, bound "
        f"{dec['bound_ms']:.4f} ms ({dec['bound_by']})")
    dec.update(_capacity_times("decode", dev, lambda g, n_kv: _decode_case(
        dev, g, 16, n_kv, [BENCH_CFG.max_seq] * N_SLOTS, stale=False, d=d)))
    out["decode"] = dec
    for name, r in out.items():
        r["max_abs_err"] = err.get(name, 0.0)
        r["shape"] = (f"{CONFIG2_128} causal" if name != "decode"
                      else f"8 slots x 16 q / 4 kv heads x 128, length {length} of 1280")
    return out


# the int8 family's tile edges at 128 (B5 walks 64-key tiles through 3
# stages, B7 128-key blocks over 64-row q tiles through 3, B8 128-row blocks
# over 64-key tiles): t and s off a multiple of 128, causal t < s and t > s,
# GQA rep 4 and 8, rep 3, one token, a ragged length whose padded K rows
# (smoothed to -k_mean) set the last K grain's scale, and more key tiles
# than stages; then the shapes the d=128 paths give the kernels, as
# INT8_CASES holds them at 64: the int8 train step's (BASELINE config 4),
# GQA rep 4 at 2048 and the int8 serving prefill's; (b, h, h_kv, t, s,
# causal, K offset)
HEAD128_INT8_CASES = [(1, 8, 8, 200, 330, True, 4.0), (1, 8, 8, 330, 200, True, 0.0),
                      (1, 16, 4, 300, 300, True, 4.0), (1, 16, 2, 257, 257, True, 0.0),
                      (1, 4, 2, 77, 201, False, 4.0), (1, 3, 1, 1, 1, True, 0.0),
                      (2, 6, 2, 33, 130, True, 4.0), (2, 16, 16, 1000, 1000, True, 4.0),
                      (1, 4, 4, 1280, 1280, False, 0.0),
                      (TRAIN_BATCH, 16, 16, TRAIN128_CFG.max_seq, TRAIN128_CFG.max_seq, True, 0.0),
                      (2, 16, 4, 2048, 2048, True, 0.0),
                      (N_SLOTS, SERVE128_CFG.n_heads, SERVE128_CFG.n_kv_heads, PROMPT_LEN,
                       PROMPT_LEN, True, 0.0)]
# nonzero global offsets, causal: the q shard after the k shard, and before
# it (rows that see no key); (b, h, h_kv, t, s, q_offset, k_offset)
HEAD128_INT8_OFFSETS = [(1, 8, 2, 256, 256, 256, 0), (1, 8, 2, 200, 330, 256, 384)]
# B6 at 128: (b, h, h_kv, t, s, causal, K offset, dtype)
HEAD128_FUSED_CASES = [(2, 16, 16, 1000, 1000, True, 4.0, torch.bfloat16),
                       (1, 16, 4, 300, 300, True, 0.0, torch.float32),
                       (1, 4, 2, 77, 201, False, 4.0, torch.bfloat16),
                       (1, 3, 1, 1, 1, True, 0.0, torch.float32),
                       (4, 16, 16, 2048, 2048, True, 0.0, torch.bfloat16)]
# BASELINE config 3 at 128 against the oracle: (h_kv, t) at 4 x 16 q heads
HEAD128_CONFIG3 = [(16, 2048), (16, 4096), (16, 8192), (4, 4096)]
# the d=128 serving model's prefill through B4 + B5: (b, h, h_kv, t), causal
SERVE128_PREFILL = (N_SLOTS, 16, 4, PROMPT_LEN)
INT8_TRAIN128_CFG = dataclasses.replace(TRAIN128_CFG, attention="int8")
INT8_SERVE128_CFG = dataclasses.replace(SERVE128_CFG, attention="int8")


def _head128_int8_kernels(dev) -> tuple[dict, dict]:
    """B4, B5, B6, B7/B8 and B14 at head dim 128 against their plain
    versions at the tolerances of their head-dim-64 phases (8, 12, 21, 23):
    B4 byte-equal on f32 and bf16 views at every grain, and within each
    case; B5, B7 and B8 at HEAD128_INT8_CASES and with global offsets, each
    kernel called twice for the same bits; B6 against B4 -> B5 (lse equal)
    and its plain version; B14 against its plain version and against B13 bit
    for bit, at spec 1 and on the verify staircase. Returns (each kernel's
    max|diff|, B7's and B8's worst max|diff| / max|plain| with its case)."""
    gen = torch.Generator(device=dev).manual_seed(33)
    _check_quant(gen, dev, HEAD128)
    errs, worst = [], {"dq": (0.0, ""), "dk": (0.0, ""), "dv": (0.0, "")}

    def case(q, k, v, do, causal, label, **offsets):
        err, rel = _check_int8(q, k, v, do, causal, label, **offsets)
        errs.append(err)
        worst.update({n: (r, label) for n, r in rel.items() if r > worst[n][0]})

    for b, h, h_kv, t, s, causal, shift in HEAD128_INT8_CASES:
        q, k, v, do = _qkvdo(gen, dev, b, h, h_kv, t, s, HEAD128)
        case(q, k + shift, v, do, causal, f"d=128 b={b} h={h} h_kv={h_kv} t={t} s={s} "
             f"causal={causal} K mean {shift}")
    for b, h, h_kv, t, s, qo, ko in HEAD128_INT8_OFFSETS:
        q, k, v, do = _qkvdo(gen, dev, b, h, h_kv, t, s, HEAD128)
        case(q, k, v, do, True, f"d=128 b={b} h={h} h_kv={h_kv} t={t} s={s} causal, q_offset "
             f"{qo} k_offset {ko}", q_offset=qo, k_offset=ko)
    err = _worst(*errs)
    err["int8_fused"] = max(
        _check_fused(*_qkv(gen, dev, b, h, h_kv, t, s, dtype, shift, HEAD128), causal,
                     f"d=128 b={b} h={h} h_kv={h_kv} t={t} s={s} causal={causal} K mean {shift} "
                     f"{dtype}") for b, h, h_kv, t, s, causal, shift, dtype in HEAD128_FUSED_CASES)
    err["paged_decode"] = 0.0
    for n_q, n_kv in ((16, 16), (16, 4)):
        q, dense8, paged8, _, _ = _paged8_case(dev, gen, n_q, n_kv, CACHE_LENGTHS, True, HEAD128)
        label = (f"d=128, 8 seqs, {n_q} q / {n_kv} kv heads, page {PAGE} x {MAX_PAGES}, lengths "
                 f"{CACHE_LENGTHS}, shuffled pages, junk pages, non-finite stale scales")
        err["paged_decode"] = max(err["paged_decode"], _check_decode_kernel(
            "paged_decode", paged_decode_attention, paged_decode_attention_plain, q, paged8,
            label))
        b14 = paged_decode_attention(q, paged8, return_lse=True)
        again = paged_decode_attention(q, paged8, return_lse=True)
        if not all(torch.equal(a, b) for a, b in zip(b14, again)):
            raise AssertionError(f"paged_decode gives other bits on a second call at {label}")
        _check_twins("paged_decode", b14, decode_attention(q, dense8, return_lse=True),
                     f"d=128 B14 on shuffled pages vs B13 dense, {n_q}/{n_kv} heads", exact=True)
        _, vdense, vpaged, _, _ = _paged8_case(dev, gen, n_q, n_kv, SPEC_LENGTHS, True, HEAD128)
        for spec in SPECS:
            qv = torch.randn((len(SPEC_LENGTHS), n_q, spec, HEAD128), generator=gen, device=dev)
            err["paged_decode"] = max(err["paged_decode"], _check_verify(
                "paged_decode", qv, vpaged, f"d=128, 8 seqs, {n_q} q / {n_kv} kv heads, lengths "
                f"{SPEC_LENGTHS}, shuffled pages, non-finite stale scales"))
            if not torch.equal(paged_verify_attention(qv, vpaged),
                               verify_decode_attention(qv, vdense)):
                raise AssertionError(f"d=128 B14's verify staircase differs from B13's at spec "
                                     f"{spec}, {n_q}/{n_kv} heads")
    log("[head128] B7/B8 worst max|diff|/max|plain| at d=128 (INT8_BWD_TOL "
        f"{INT8_BWD_TOL}): " + "; ".join(f"{n} {r:.3e} at {where}" for n, (r, where)
                                         in worst.items()))
    return err, {n: {"rel": r, "case": where} for n, (r, where) in worst.items()}


def _head128_int8_timing(dev, sdpa: dict, census: bool) -> tuple[dict, dict]:
    """Config 4's shape (phase 8's timing at 128: B4, B5, B7, B8 beside their
    plain versions, bounds and SDPA's d=128 bf16 forward and backward; B7/B8
    at GQA rep 4), config 3's (phase 14 at 128: the inference path once at
    each length, then B6 at 2048-8192 and GQA), B4 + B5 at the d=128 serving
    model's prefill, and B14 at its decode shape and at capacity. Returns
    ({kernel: times}, the config 3 path's launches)."""
    gen = torch.Generator(device=dev).manual_seed(35)
    out = phase_int8_timing(dev, gen, sdpa, HEAD128, census)
    out["int8_fused"], infer_launches = phase_int8_infer_timing(dev, gen, HEAD128)
    b, h, h_kv, t = SERVE128_PREFILL
    q, k, v = _qkv(gen, dev, b, h, h_kv, t, t, torch.bfloat16, d=HEAD128)
    k_mean = k.float().mean(-2, keepdim=True)
    res = quantize_qkv(q, k, v, k_sub=k_mean)
    dims = (b, h, t, t, HEAD128)
    o, lse = int8_attention_fwd_from_quantized(res, dims, causal=True)
    pairs = b * h * visible_pairs(t, t, True)
    prefill = {
        "quant_int8_ms": device_ms(lambda: quantize_qkv(q, k, v, k_sub=k_mean)),
        "int8_fwd_ms": device_ms(lambda: int8_attention_fwd_from_quantized(res, dims, True)),
        "int8_fwd_plain_ms": device_ms(lambda: int8_attention_fwd_from_quantized_plain(
            res, dims, True), calls=4, replays=5),
        "int8_fwd_bound_ms": bound(nbytes(*(x for pair in res for x in pair), o, lse),
                                   (2 * pairs * HEAD128, PEAK_INT8),
                                   (2 * pairs * HEAD128, PEAK_BF16))["bound_ms"],
        "sdpa_ms": device_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                                     enable_gqa=True)),
        "shape": f"{SERVE128_PREFILL} x 128 causal, bf16 in"}
    log(f"[head128] serving prefill {SERVE128_PREFILL} x 128 causal: B4 "
        f"{prefill['quant_int8_ms']:.4f} ms, B5 {prefill['int8_fwd_ms']:.4f} ms (plain "
        f"{prefill['int8_fwd_plain_ms']:.4f} ms, bound {prefill['int8_fwd_bound_ms']:.4f} ms), "
        f"sdpa bf16 {prefill['sdpa_ms']:.4f} ms")
    out["int8_fwd"]["serve128_prefill"] = prefill
    del res, o, lse
    # B14 at the serving decode shape of SERVE128_CFG (beside B13 on the same
    # K/V) and at capacity
    length = PROMPT_LEN + NEW_TOKENS // 2
    q, dense8, paged8, _, _ = _paged8_case(dev, gen, 16, 4, [length] * N_SLOTS, False, HEAD128)
    o = paged_decode_attention(q, paged8)
    n_tok = length * N_SLOTS
    live_pages = N_SLOTS * -(-length // PAGE)
    dec = {"ms": device_ms(lambda: paged_decode_attention(q, paged8)),
           "plain_ms": device_ms(lambda: paged_decode_attention_plain(q, paged8)),
           "decode_ms_beside": device_ms(lambda: decode_attention(q, dense8)),
           **bound(n_tok * 4 * 2 * (HEAD128 + 4) + 4 * live_pages + nbytes(q, o, paged8.lengths),
                   (2 * 2 * n_tok * q.shape[1] * HEAD128, PEAK_BF16)),
           "library_ms": None}
    log(f"[head128] paged_decode d=128, 8 seqs x 16 q / 4 kv heads, length {length} of "
        f"{BENCH_CFG.max_seq}: kernel {dec['ms']:.4f} ms (B13 {dec['decode_ms_beside']:.4f} ms), "
        f"plain {dec['plain_ms']:.4f} ms, bound {dec['bound_ms']:.4f} ms ({dec['bound_by']})")
    dec.update(_capacity_times("paged_decode", dev, lambda g, n_kv: _paged8_case(
        dev, g, 16, n_kv, [BENCH_CFG.max_seq] * N_SLOTS, False, HEAD128)[::2][:2]))
    out["paged_decode"] = dec
    shapes = {"quant_int8": "(4, 16, 2048, 128) causal", "int8_fwd": "(4, 16, 2048, 128) causal",
              "int8_bwd_dkv": "(4, 16, 2048, 128) causal",
              "int8_bwd_dq": "(4, 16, 2048, 128) causal",
              "int8_fused": "(4, 16, 2048, 128) causal, bf16 in",
              "paged_decode": f"8 seqs x 16 q / 4 kv heads x 128, length {length} of 1280"}
    for name, r in out.items():
        r["shape"] = shapes[name]
    return out, infer_launches


def _head128_int8_paths(dev, smi, bf16_norms) -> dict:
    """make_train_step at INT8_TRAIN128_CFG (phase 10's parity and exact
    launches: B4, B5, B7, B8 n_layers times a step; config 4's gradient-norm
    ratio against the bf16 run at TRAIN128_CFG under GRAD_NORM_RATIO), then
    ServingEngine at INT8_SERVE128_CFG on the slotted cache (B13) and on
    cache="paged" (B14): prefill through B4 + B5 (rep 4), f32 params' tokens
    equal `generate`'s, bf16 params' tokens/s. Returns the launches by path,
    the train step and the tokens/s."""
    launches, run = phase_train(dev, smi, INT8_TRAIN128_CFG)
    ratios = [a / b for a, b in zip(run["grad_norms"], bf16_norms)]
    log(f"[head128] int8 train step at TRAIN128_CFG: global grad norm int8 / bf16 per step "
        f"{[round(r, 4) for r in ratios]} (limit {GRAD_NORM_RATIO})")
    if not all(np.isfinite(ratios)) or max(ratios) >= GRAD_NORM_RATIO:
        raise AssertionError("int8 gradient norms at head dim 128 left 2x the bf16 run's "
                             "(BASELINE config 4)")
    paths = {"train128_int8": launches}
    speed = {}
    n_layers = INT8_SERVE128_CFG.n_layers
    for path, decode, kw in (("serve128_int8", "decode", {}),
                             ("serve128_int8_paged", "paged_decode", {"cache": "paged"})):
        for dtype in (torch.float32, torch.bfloat16):
            _, counts, tok_s, _ = _serve(dev, smi, INT8_SERVE128_CFG, param_dtype=dtype, **kw)
            used = {k: v for k, v in counts.items() if v}
            if set(used) != {"quant_int8", "int8_fwd", decode} or \
                    used["quant_int8"] != n_layers or used["int8_fwd"] != n_layers:
                raise AssertionError(f"{path}: the d=128 int8 served run launched {used}, want "
                                     f"quant_int8 and int8_fwd {n_layers} times (one batched "
                                     f"prefill) and {decode}")
        paths[path] = used
        speed[path] = tok_s
    log(f"[head128] int8 serving at SERVE128_CFG, bf16 params: "
        + ", ".join(f"{p} {s:.1f} tokens/s" for p, s in speed.items()))
    return {"launches": paths, "train": {"median_step_ms": run["median_ms"],
                                         "max_memory_gib": run["max_memory_gib"],
                                         "grad_norm_ratios": ratios},
            "tokens_per_s": speed}


# the rCM DiT at Wan 2.1's head dim: config 5's sequence, 4 heads x 128 =
# d_model 512 (heads x head_dim = d_model, as in DIT_CFG); its attention is
# (DIT_BATCH, 4, 4096, 128), non-causal
DIT128_CFG = DiTConfig(d_model=512, n_heads=4, head_dim=HEAD128, n_layers=2, seq_len=4096)
DIT128_SHAPE = (DIT_BATCH, DIT128_CFG.n_heads, DIT128_CFG.seq_len)
# B9 fast walks 32-key tiles at 128 and B12 32-key tiles, B11 128-key blocks
# over 32-row q tiles, B1 fp32 32-key tiles: t and s off 64 and 32, causal t
# < s and t > s, one token, the DiT's shape; (b, h, t, s, causal)
HEAD128_JVP_CASES = [(1, 4, 200, 330, True), (1, 4, 330, 200, False), (1, 3, 77, 201, True),
                     (1, 3, 33, 130, False), (2, 4, 1024, 1024, True), (1, 2, 1, 1, True),
                     (DIT_BATCH, DIT128_CFG.n_heads, DIT128_CFG.seq_len, DIT128_CFG.seq_len,
                      False)]
# B1 fp32's tile edges at 128 with GQA and rep 3 (b, h, h_kv, t, s, causal)
HEAD128_FP32_CASES = [(1, 2, 2, 330, 200, True), (1, 6, 2, 129, 65, False),
                      (1, 8, 2, 300, 300, True), (1, 2, 2, 1, 300, False),
                      (1, 2, 2, 300, 1, True)]
HEAD128_INT4_ROWS = ("flash_fwd_fp32", "jvp_fwd", "jvp_bwd_dkv", "jvp_bwd_dq", "decode4",
                     "paged4_decode")


def _head128_rcm_int4_kernels(dev) -> dict:
    """B15/B16 and the rCM step's kernels (B1 fp32, B9, B11, B12 fast) at
    head dim 128 against their plain versions, at the tolerances of their
    head-dim-64 phases (21, 23, 17). B15/B16: phase 21's lengths (one token,
    off the 256-token chunk and the 128-row pack half, full capacity) with
    shuffled and junk pages and non-finite stale scales, 16/16 and 16/4
    heads, B16 bit-equal to B15; phase 23's verify staircase at spec 2 and 5,
    each row bit-equal to its spec = 1 launch. B1 fp32 and B9-B12 in both
    modes at HEAD128_JVP_CASES on the DiT's [b, h, t, d] views of [b, t, h,
    d] tensors, each called twice for the same bits, the fast preps
    byte-equal to the plain preps (phase 17's `_check_jvp`); B1 fp32 also at
    its tile edges under GQA. Returns each kernel's max|diff|."""
    gen = torch.Generator(device=dev).manual_seed(35)
    err = dict.fromkeys((*HEAD128_INT4_ROWS, "jvp_tangent"), 0.0)
    kernels = {"decode4": (decode_attention_int4, decode_attention_int4_plain),
               "paged4_decode": (paged4_decode_attention, paged4_decode_attention_plain)}
    for n_q, n_kv in ((16, 16), (16, 4)):
        q, _, _, dense4, paged4 = _cache_kinds(dev, gen, n_q, n_kv, CACHE_LENGTHS, True, HEAD128)
        label = (f"d=128, 8 seqs, {n_q} q / {n_kv} kv heads, lengths {CACHE_LENGTHS}, shuffled "
                 f"pages, junk pages, non-finite stale scales")
        for name, cache in (("decode4", dense4), ("paged4_decode", paged4)):
            err[name] = max(err[name], _check_decode_kernel(name, *kernels[name], q, cache, label))
            _same_bits(name, kernels[name][0](q, cache, return_lse=True),
                       kernels[name][0](q, cache, return_lse=True), label)
        _check_twins("paged4_decode", paged4_decode_attention(q, paged4, return_lse=True),
                     decode_attention_int4(q, dense4, return_lse=True),
                     f"d=128 B16 on shuffled pages vs B15 dense, {n_q}/{n_kv} heads", exact=True)
        _, _, _, dense4, paged4 = _cache_kinds(dev, gen, n_q, n_kv, SPEC_LENGTHS, True, HEAD128)
        for spec in SPECS:
            qv = torch.randn((len(SPEC_LENGTHS), n_q, spec, HEAD128), generator=gen, device=dev)
            for name, cache in (("decode4", dense4), ("paged4_decode", paged4)):
                err[name] = max(err[name], _check_verify(
                    name, qv, cache, f"d=128, 8 seqs, {n_q} q / {n_kv} kv heads, lengths "
                    f"{SPEC_LENGTHS}, non-finite stale scales"))
    for b, h, t, s, causal in HEAD128_JVP_CASES:
        inputs = _strided(*_jvp_inputs(gen, dev, b, h, t, s, HEAD128))
        got = _check_jvp(*inputs, causal, f"d=128 ({b},{h},{t},{s}) DiT views causal={causal}",
                         modes=(True, False), every_bit=True)
        err.update({k: max(err[k], got[k]) for k in err if k in got})
        del inputs
    msgs = []
    for b, h, h_kv, t, s, causal in HEAD128_FP32_CASES:
        label = f"({b},{h}q/{h_kv}kv,{t}x{s},128) causal={causal}"
        q, k, v, _ = _qkvdo(gen, dev, b, h, h_kv, t, s, HEAD128)
        got = flash_attention_fwd_fp32(q, k, v, causal=causal)
        _same_bits("flash_fwd_fp32", got, flash_attention_fwd_fp32(q, k, v, causal=causal), label)
        o_p, lse_p = flash_attention_fwd_plain(q, k, v, causal=causal, precision="fp32")
        e = (got[0] - o_p).abs().max().item()
        rel, e_l = e / o_p.abs().max().item(), (got[1] - lse_p).abs().max().item()
        msgs.append(f"{label} O {rel:.2e} lse {e_l:.2e}")
        if max(rel, e_l) > JVP_EXACT_TOL or not torch.isfinite(got[0]).all():
            raise AssertionError(f"flash_fwd_fp32 disagrees with its plain version at {label}")
        err["flash_fwd_fp32"] = max(err["flash_fwd_fp32"], e)
    log(f"[head128] flash_fwd_fp32 tile edges at 128 (tol {JVP_EXACT_TOL}; each bit-equal on a "
        "second call): " + "; ".join(msgs))
    return err


def _head128_int4_timing(dev) -> dict:
    """Device time of B15 and B16 at the serving decode shape of
    SERVE128_CFG (8 slots x 16 q / 4 kv heads, length 304 of 1280) beside
    their plain versions, and at capacity. Returns {kernel: times}."""
    d = HEAD128
    gen = torch.Generator(device=dev).manual_seed(36)
    out = {}
    length = PROMPT_LEN + NEW_TOKENS // 2
    q, _, _, dense4, paged4 = _cache_kinds(dev, gen, 16, 4, [length] * N_SLOTS, False, d)
    n_tok = length * N_SLOTS
    live_pages = N_SLOTS * -(-length // PAGE)
    for name, cache, table_bytes, at in (("decode4", dense4, 0, 3),
                                         ("paged4_decode", paged4, 4 * live_pages, 4)):
        fn = {"decode4": decode_attention_int4, "paged4_decode": paged4_decode_attention}[name]
        plain = {"decode4": decode_attention_int4_plain,
                 "paged4_decode": paged4_decode_attention_plain}[name]
        o = fn(q, cache)
        # the live tokens' int4 K/V (d / 2 bytes each) and scales per kv head
        n_bytes = n_tok * 4 * 2 * (d // 2 + 4) + table_bytes + nbytes(q, o, cache[-1])
        row = {"ms": device_ms(lambda: fn(q, cache)),
               "plain_ms": device_ms(lambda: plain(q, cache), calls=4, replays=5),
               **bound(n_bytes, (2 * 2 * n_tok * q.shape[1] * d, PEAK_BF16)),
               "library_ms": None,
               "shape": f"8 slots x 16 q / 4 kv heads x 128, length {length} of 1280"}
        log(f"[head128] {name} d=128, {row['shape']}: kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']})")

        def case(g, n_kv, at=at):
            kinds = _cache_kinds(dev, g, 16, n_kv, [BENCH_CFG.max_seq] * N_SLOTS, False, d)
            return kinds[0], kinds[at]
        row.update(_capacity_times(name, dev, case))
        out[name] = row
    return out


def _head128_rcm_int4_paths(dev, smi) -> tuple[dict, dict]:
    """ServingEngine(kv_quant="int4") at SERVE128_CFG (bf16 params) on the
    slotted (B15) and paged (B16) caches: each run launches only B1 (one
    batched prefill, n_layers times) and its cache's int4 decode kernel, and
    the paged run's tokens equal the slotted run's; then the rCM step at
    DIT128_CFG (phase 20 at 128: card-vs-CPU parity at seq DIT_PARITY_LEN in
    both modes, central differences, torch.func.jvp of dit_forward through
    B10 once a layer, 1 + 5 steps with losses finite and falling and exact
    launches a step).
    Returns (launches by path, step and serving numbers)."""
    n_layers = SERVE128_CFG.n_layers
    paths, speed, tokens = {}, {}, {}
    for path, decode, kw in (("serve128_kv4", "decode4", {}),
                             ("serve128_paged4", "paged4_decode", {"cache": "paged"})):
        tokens[path], counts, tok_s, _ = _serve(dev, smi, SERVE128_CFG, kv_quant="int4", **kw)
        used = {k: v for k, v in counts.items() if v}
        if set(used) != {"flash_fwd", decode} or used["flash_fwd"] != n_layers:
            raise AssertionError(f"{path}: the d=128 int4 served run launched {used}, want "
                                 f"flash_fwd {n_layers} times (one batched prefill) and {decode}")
        paths[path], speed[path] = used, tok_s
    same = tokens["serve128_paged4"] == tokens["serve128_kv4"]
    log(f"[head128] int4 serving at SERVE128_CFG, bf16 params: "
        + ", ".join(f"{p} {s:.1f} tokens/s" for p, s in speed.items())
        + f"; paged int4 tokens == slotted int4 tokens: {same}")
    if not same:
        raise AssertionError("the paged int4 cache served other tokens than the slotted one at "
                             "head dim 128")
    dit_launches, dit_jvp, dit = phase_dit(dev, smi, DIT128_CFG, profile=False,
                                           modes=(True, False))
    paths["dit_rcm128"] = {k: n for k, n in dit_launches.items() if n}
    paths["dit_jvp128_seq512"] = {k: n for k, n in dit_jvp.items() if n}
    return paths, {"serve128_int4_tokens_per_s": speed,
                   "dit_rcm128": {k: dit[k] for k in ("median_ms", "max_memory_gib",
                                                      "tokens_per_s", "losses")}}


# B2/B3 exact timed at config 2's batch and heads at 128 (b, h, t), causal
EXACT_BWD128 = (4, 16, 2048)


def _head128_exact_kernels(dev) -> dict:
    """B10 exact on the dit_jvp path's [b, h, t, d] views at (2, 4, 512,
    128), whose keys it splits into ranges (z > 1): its plain version at
    JVP_EXACT_TOL, the same bits on a second call, its prep byte-equal to
    the plain prep; then B2/B3 exact at phase 6's tile and edge cases at
    head dim 128 (BWD_EXACT_TOL, the same bits on a second call) on B1
    fp32's residuals, as attention_jvp hands them on. Returns each kernel's
    max|diff|."""
    gen = torch.Generator(device=dev).manual_seed(39)
    b, h, t = 2, DIT128_CFG.n_heads, DIT_PARITY_LEN
    label = f"({b},{h},{t},128) DiT views"
    q, k, v, tq, tk, tv = _strided(*_jvp_inputs(gen, dev, b, h, t, t, HEAD128)[:6])
    o, lse = flash_attention_fwd_fp32(q, k, v)
    got = attention_tangent_fwd(q, k, v, o, lse, tq, tk, tv)
    _same_bits("jvp_tangent", (got,), (attention_tangent_fwd(q, k, v, o, lse, tq, tk, tv),), label)
    want = attention_tangent_fwd_plain(q, k, v, o, lse, tq, tk, tv)
    err = {"jvp_tangent": (got - want).abs().max().item()}
    rel = err["jvp_tangent"] / want.abs().max().item()
    prep_ok = all(torch.equal(_bits(a), _bits(w_)) for a, w_ in
                  zip(tangent_prep(k, v, tk, tv), tangent_prep_plain(k, v, tk, tv)))
    _, z, per = jvp_tiling.tangent_grid(b * h, t, t, torch.cuda.get_device_properties(
        dev).multi_processor_count, HEAD128)
    log(f"[head128] jvp_tangent exact (3xTF32) {label}: tO max|diff|/max|plain| {rel:.2e} (tol "
        f"{JVP_EXACT_TOL}; {z} key ranges of {per} tiles; bit-equal on a second call; prep "
        f"byte-equal {prep_ok})")
    if rel > JVP_EXACT_TOL or z < 2 or not torch.isfinite(got).all() or not prep_ok:
        raise AssertionError(f"[head128] jvp_tangent exact at {label}: {rel:.2e}, z={z}, prep "
                             f"byte-equal {prep_ok}")
    del q, k, v, tq, tk, tv, o, lse, got, want
    err.update(flash_bwd_dkv=0.0, flash_bwd_dq=0.0)
    for b, h, h_kv, t, s_, causal in BWD_TILE_CASES + BWD_EDGE_CASES:
        q, k, v, do = _qkvdo(gen, dev, b, h, h_kv, t, s_, HEAD128)
        o, lse = flash_attention_fwd_fp32(q, k, v, causal=causal)
        e = _check_bwd(bwd_operands(q, k, v, o, lse, do, causal=causal, fast=False),
                       f"d=128 b={b} h={h} h_kv={h_kv} t={t} s={s_} causal={causal}")
        err.update({name: max(err[name], x) for name, x in e.items()})
    return err


def _head128_exact_bwd_timing(dev) -> dict:
    """B2 and B3 exact at EXACT_BWD128 x 128, causal, on B1 fp32's
    residuals: device time (CUDA-graph replays) beside their bounds at the
    fp32 CUDA-core peak and SDPA's f32 backward. Returns {kernel: exact_*
    entries}."""
    b, h, t = EXACT_BWD128
    d = HEAD128
    q, k, v, do = _qkvdo(torch.Generator(device=dev).manual_seed(40), dev, b, h, h, t, t, d)
    o, lse = flash_attention_fwd_fp32(q, k, v, causal=True)
    ops = bwd_operands(q, k, v, o, lse, do, causal=True, fast=False)
    dk, dv = flash_bwd_dkv(ops)
    dq = flash_bwd_dq(ops)
    pairs = b * h * visible_pairs(t, t, True)
    from torch.nn.attention import SDPBackend

    sdpa = _sdpa_bwd_ms(q, k, v, do, torch.float32, [SDPBackend.EFFICIENT_ATTENTION], calls=2,
                        replays=3)
    call = ("backward of F.scaled_dot_product_attention(is_causal=True), f32, memory-efficient "
            "backend: dq, dk, dv together")
    shape = f"({b},{h},{t},{d}) causal, exact"
    out = {}
    for name, fn, outs, dots in (("flash_bwd_dkv", lambda: flash_bwd_dkv(ops), (dk, dv), 4),
                                 ("flash_bwd_dq", lambda: flash_bwd_dq(ops), (dq,), 3)):
        bnd = bound(nbytes(*ops[:6], *outs), (dots * 2 * pairs * d, PEAK_FP32))
        out[name] = {"exact_ms": device_ms(fn, calls=1, replays=3),
                     "exact_bound_ms": bnd["bound_ms"], "exact_bound_by": bnd["bound_by"],
                     "exact_library_ms": sdpa, "exact_library_call": call,
                     "exact_shape": shape}
        r = out[name]
        log(f"[head128] {name} {shape}: {r['exact_ms']:.4f} ms, bound {r['exact_bound_ms']:.4f} "
            f"ms at the fp32 CUDA-core peak ({r['exact_bound_by']}), "
            f"{r['exact_ms'] / r['exact_bound_ms']:.2f}x; sdpa f32 backward {sdpa:.4f} ms")
    return out


def phase_head128(dev, smi, alone: bool = False) -> dict:
    """Phase 30: head dim 128 on the main paths. The bf16 kernels (B1-B3,
    B13) and the int8 family (B4-B8, B14) at their tile edges, BASELINE
    configs 2, 3 and 4 against the fp32 oracle, the timings, then
    make_train_step at TRAIN128_CFG in bf16 and int8 (phase 10's parity,
    steps and exact launches; the int8/bf16 gradient-norm ratio) and
    ServingEngine at SERVE128_CFG in bf16 and with int8 prefill on the
    slotted and paged caches (f32 params: tokens equal `generate`'s; bf16
    params: tokens/s). Then B15/B16 and the rCM step's kernels (B1 fp32, B9,
    B11, B12 fast) at their tile edges and timed, ServingEngine(kv_quant=
    "int4") at SERVE128_CFG on both caches and the rCM step at DIT128_CFG.
    Then the exact modes: B10 (both modes) and the exact B9, B11 and B12 at
    the same edges (in _head128_rcm_int4_kernels) and timed, B10 exact with
    its keys split, B2/B3 exact at phase 6's edges and timed beside SDPA's
    f32 backward, BASELINE config 5's gate at 128, torch.func.jvp of
    dit_forward at full size and make_dit_rcm_step(fast=False) at
    DIT128_CFG. Returns {kernel: its d=128 entry} with the launches of every
    path.
    `alone`: the process runs no other phase, so B4's profile census must
    record (phase_int8_timing)."""
    errs = _head128_kernels(dev)
    int8_errs, bwd_rel = _head128_int8_kernels(dev)
    _head128_oracle(dev)
    gen = torch.Generator(device=dev).manual_seed(34)
    phase_int8_oracle(dev, gen, HEAD128)
    phase_int8_infer_oracle(dev, gen, HEAD128, HEAD128_CONFIG3)
    out = _head128_timing(dev)
    sdpa = {"fwd": out["flash_fwd"]["library_ms"], "bwd": out["flash_bwd_dq"]["library_ms"]}
    timing, infer_launches = _head128_int8_timing(dev, sdpa, census=alone)
    out.update(timing)
    for name, e in {**errs, **int8_errs}.items():
        out[name]["max_abs_err"] = max(out[name].get("max_abs_err", 0.0), e)
    for name, key in (("int8_bwd_dq", "dq"), ("int8_bwd_dkv", "dk"), ("int8_bwd_dkv", "dv")):
        out[name][f"worst_rel_{key}"] = bwd_rel[key]
    train_launches, run = phase_train(dev, smi, TRAIN128_CFG)
    int8 = _head128_int8_paths(dev, smi, run["grad_norms"])
    serve = {}
    for dtype in (torch.float32, torch.bfloat16):
        _, launches, tok_s, _ = _serve(dev, smi, SERVE128_CFG, param_dtype=dtype)
        used = {k: v for k, v in launches.items() if v}
        if set(used) != {"flash_fwd", "decode"} or used["flash_fwd"] != SERVE128_CFG.n_layers:
            raise AssertionError(f"the d=128 served run launched {used}, want flash_fwd "
                                 f"{SERVE128_CFG.n_layers} times (one batched prefill) and decode")
        serve[str(dtype)[6:]] = {"launches": used, "tokens_per_s": tok_s}
    log(f"[head128] train step at TRAIN128_CFG: median {run['median_ms']:.2f} ms, "
        f"max_memory_allocated {run['max_memory_gib']:.2f} GiB, launches {train_launches}; "
        f"serving at SERVE128_CFG: {serve}")
    rcm_errs = _head128_rcm_int4_kernels(dev)
    rcm_timing = phase_jvp_timing(dev, torch.Generator(device=dev).manual_seed(37), HEAD128)
    for name, row in {**rcm_timing, **_head128_int4_timing(dev)}.items():
        out[name] = {**row, "max_abs_err": rcm_errs[name]}
    rcm_paths, rcm_runs = _head128_rcm_int4_paths(dev, smi)
    # the exact modes at 128: B10 (split keys), B2/B3 exact at their edges
    # and timed, config 5's gate, the forward-mode DiT and the exact rCM step
    exact_errs = _head128_exact_kernels(dev)
    for name, e in exact_errs.items():
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], e)
    for name, row in _head128_exact_bwd_timing(dev).items():
        out[name].update(row)
    oracle128 = phase_jvp_oracle(dev, torch.Generator(device=dev).manual_seed(38), HEAD128)
    dit_exact_paths, dit_exact = _dit_exact(dev, smi, DIT128_CFG)
    paths = {"train128": train_launches, "serve128": serve["bfloat16"]["launches"],
             **int8["launches"], "infer128_int8": infer_launches, **rcm_paths,
             "jvp_oracle128": oracle128, **dit_exact_paths}
    for name in HEAD128_ROWS:
        by_path = {p: counts.get(name, 0) for p, counts in paths.items()}
        out[name]["launches_by_path"] = {p: n for p, n in by_path.items() if n}
    out["flash_bwd_dkv"]["prep_launches_by_path"] = {"train128": train_launches["flash_bwd_prep"]}
    for name, prep in (("flash_fwd_fp32", "flash_fwd_fp32_prep"), ("jvp_fwd", "jvp_fwd_prep"),
                       ("jvp_bwd_dkv", "jvp_bwd_prep")):
        out[name]["prep_launches_by_path"] = {
            p: paths[p].get(prep, 0) for p in ("dit_rcm128", "dit_rcm128_exact", "dit_jvp128",
                                               "dit_jvp128_seq512", "jvp_oracle128")
            if paths[p].get(prep, 0)}
    out.update(rcm_runs)
    out.update(dit_exact)
    out["train128"] = {"median_step_ms": run["median_ms"], "max_memory_gib": run["max_memory_gib"]}
    out["train128_int8"] = int8["train"]
    out["serve128_tokens_per_s"] = {"serve128": serve["bfloat16"]["tokens_per_s"],
                                    **int8["tokens_per_s"]}
    return out


def _head128_rows(kernels: list, head128: dict) -> None:
    """Phase 30's numbers into the `kernels` line: each kernel of
    HEAD128_ROWS gains its d=128 entry and its paths' launches."""
    for k in kernels:
        if k["name"] in HEAD128_ROWS:
            row = dict(head128[k["name"]])
            k["launches_by_path"].update(row.pop("launches_by_path"))
            if "prep_launches_by_path" in row:
                k["prep_launches_by_path"].update(row.pop("prep_launches_by_path"))
            k["max_abs_err"] = max(k["max_abs_err"], row["max_abs_err"])
            k["head_dim_128"] = row


# --------------------------------------------------------------------------
# Phase 31: B1's "beta" and "none" corrections, B18 at any scale group
# (`python3 chip_smoke.py options` runs phases 1, 2 and 31 alone)
# --------------------------------------------------------------------------

RULE_TRAIN = (4, 16, 2048)  # (b, h, t): BASELINE config 2's attention shape
RULE_DIT = (DIT_BATCH, DIT_CFG.n_heads, DIT_CFG.seq_len)  # the DiT's, non-causal
# B1's rules at the train shapes, GQA and the edges: (b, h, h_kv, t, s,
# causal, d). t and s off a multiple of 128; s within one key group (grain
# 256); three groups of 384 (s = 1152); four groups of 640 = 5 key tiles at
# d=64, 10 at d=128 (s = 2500)
RULE_CASES = [(4, 16, 16, 2048, 2048, True, 64), (4, 16, 16, 2048, 2048, True, HEAD128),
              (2, 16, 4, 2048, 2048, True, 64), (2, 16, 4, 2048, 2048, True, HEAD128),
              (1, 4, 4, 200, 330, True, 64), (1, 4, 2, 77, 201, False, 64),
              (1, 4, 2, 300, 1152, False, 64), (1, 6, 2, 1152, 1152, True, HEAD128),
              (1, 4, 4, 2500, 2500, True, 64), (1, 2, 2, 2500, 2500, False, HEAD128)]
# the fp32 mode's: (b, h, h_kv, t, s, causal, d), the DiT's attention shape
# (8 key groups of 512), GQA rep 4 over three groups (the last of 128 keys),
# causal and not within one group (grain 256: s = 200, 201) and over two
# (900 = 512 + 388), at both head dims (32-key tiles at 128)
RULE_FP32_CASES = [(*RULE_DIT[:2], RULE_DIT[1], RULE_DIT[2], RULE_DIT[2], False, d)
                   for d in (64, HEAD128)] + [
    (1, 8, 2, 1152, 1152, True, 64), (1, 2, 2, 330, 200, True, 64),
    (1, 8, 2, 1152, 1152, True, HEAD128), (1, 2, 2, 330, 200, True, HEAD128),
    (1, 2, 2, 77, 201, False, HEAD128), (1, 2, 1, 600, 900, False, HEAD128)]
# B18's groups that are not multiples of 64, at decode and prefill rows of
# the bench widths' w1 and w2
ANY_GROUPS = (8, 32, 48, 96)
ANY_SHAPES = [(m, k, n) for m in (N_SLOTS, N_SLOTS * PROMPT_LEN)
              for k, n in ((1024, 4096), (4096, 1024))]
ANY_GROUP = 32  # the row's group: its times, and the quantized LM's
LM_G32_NEW = 4  # decode steps of the group-32 LM path


def _tied(gen, dev, b, h, h_kv, t, s, d):
    """Unit-normal q, k, v whose keys 3 and 9, and s - 5 and s - 2, are
    duplicated and large: the rows whose maximum they are tie, and "beta"
    fires there."""
    q = torch.randn((b, h, t, d), generator=gen, device=dev)
    k, v = (torch.randn((b, h_kv, s, d), generator=gen, device=dev) for _ in range(2))
    u = torch.randn((b, h_kv, 2, d), generator=gen, device=dev) * 2.0
    k[:, :, 3] = k[:, :, min(9, s - 1)] = u[:, :, 0]
    k[:, :, max(s - 5, 0)] = k[:, :, s - 2] = 1.2 * u[:, :, 1]
    return q, k, v


def _check_rule(fwd, plain, q, k, v, rule, label, tol_o, tol_l, rel=False, **kw):
    """A rule's kernel against its plain version (O, lse), and the same bits
    from a second call. Returns (max|dO| or, rel, its share of max|O|, the
    kernel's O and lse)."""
    o, lse = fwd(q, k, v, correction=rule, **kw)
    o2, lse2 = fwd(q, k, v, correction=rule, **kw)
    torch.cuda.synchronize()
    if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
        raise AssertionError(f"{rule} gave other bits on a second call at {label}")
    o_p, lse_p = plain(q, k, v, correction=rule, **kw)
    err_o = (o - o_p).abs().max().item() / (o_p.abs().max().item() if rel else 1.0)
    seen = torch.isfinite(lse_p)
    err_l = (lse - lse_p)[seen].abs().max().item() if seen.any() else 0.0
    if not torch.equal(seen, torch.isfinite(lse)):
        raise AssertionError(f"{rule}: the rows that see no key differ at {label}")
    log(f"[options] {rule} {label}: max|dO|{'/max|O|' if rel else ''}={err_o:.3e} (tol {tol_o}) "
        f"max|dlse|={err_l:.3e} (tol {tol_l})")
    if not (torch.isfinite(o).all() and err_o <= tol_o and err_l <= tol_l):
        raise AssertionError(f"flash_fwd correction={rule!r} disagrees with its plain version")
    return err_o, o, lse


def _options_b1(dev) -> dict:
    """B1 bf16 under "beta" and "none" against its plain version at
    RULE_CASES (f32 and bf16 inputs at the first), with duplicated keys so
    that "beta" fires (its share of rows printed), offsets, JAX's
    extreme-logit row; the fp32 mode at RULE_FP32_CASES, where "beta" must
    fire too. Returns each instance's max|dO|."""
    gen = torch.Generator(device=dev).manual_seed(31)
    errs = {"flash_fwd_beta": 0.0, "flash_fwd_none": 0.0, "flash_fwd_fp32_beta": 0.0,
            "flash_fwd_fp32_none": 0.0}
    for b, h, h_kv, t, s, causal, d in RULE_CASES:
        q, k, v = _tied(gen, dev, b, h, h_kv, t, s, d)
        label = f"({b},{h}q/{h_kv}kv,{t},{s},{d}) causal={causal}"
        inputs = [(q, k, v, "f32 in")]
        if (b, h, t) == RULE_TRAIN:
            inputs.append((*(x.to(torch.bfloat16) for x in (q, k, v)), "bf16 in"))
        for qq, kk, vv, kind in inputs:
            for rule in ("beta", "none"):
                e, o, _ = _check_rule(flash_attention_fwd, flash_attention_fwd_plain, qq, kk, vv,
                                      rule, f"{label}, {kind}", FLASH_O_TOL, FLASH_LSE_TOL,
                                      causal=causal)
                errs[f"flash_fwd_{rule}"] = max(errs[f"flash_fwd_{rule}"], e)
                if rule == "beta":  # where the rule fired: the output differs from tol=-inf's
                    off, _ = flash_attention_fwd(qq, kk, vv, causal=causal, correction="beta",
                                                 tol=-math.inf)
                    share = (o != off).any(-1).float().mean().item()
                    log(f"[options] beta {label}, {kind}: the rule fired on {share:.3f} of the "
                        f"rows")
                    if not share > 0.0:
                        raise AssertionError(f"beta never fired at {label}")
    # offsets under "beta": a later shard's queries, and rows that see no key
    for qo, ko in ((256, 0), (0, 128)):
        q, k, v = _tied(gen, dev, 1, 4, 2, 256, 512, 64)
        e, _, _ = _check_rule(flash_attention_fwd, flash_attention_fwd_plain, q, k, v, "beta",
                              f"(1,4q/2kv,256,512,64) causal q_offset={qo} k_offset={ko}",
                              FLASH_O_TOL, FLASH_LSE_TOL, causal=True, q_offset=qo, k_offset=ko)
        errs["flash_fwd_beta"] = max(errs["flash_fwd_beta"], e)
    # JAX's extreme-logit row (tests/test_bf16_attention.py:101-127): 8 exactly
    # tied keys at exp2-domain logit ~200; beta amplifies to ~400 and every P
    # of the row underflows: O = 0, lse finite and ~200 above eps's
    q, k, v = (torch.randn((1, 1, 128, 64), generator=gen, device=dev) for _ in range(3))
    u = torch.full((64,), 64 ** -0.5, device=dev) * math.sqrt(200.0 * 8.0 / LOG2_E)
    q[0, 0, -1] = u
    k[0, 0, :8] = u
    e, o_b, lse_b = _check_rule(flash_attention_fwd, flash_attention_fwd_plain, q, k, v, "beta",
                                "(1,1,128,128,64) extreme tied logits", FLASH_O_TOL,
                                FLASH_LSE_TOL)
    errs["flash_fwd_beta"] = max(errs["flash_fwd_beta"], e)
    _, lse_e = flash_attention_fwd(q, k, v)
    gap = (lse_b[0, 0, -1] - lse_e[0, 0, -1]).item()
    log(f"[options] beta extreme row: max|O| {o_b[0, 0, -1].abs().max().item():.3e}, lse - "
        f"lse_eps {gap:.2f} (JAX: O = 0, gap > 50)")
    if not (o_b[0, 0, -1].abs().max().item() == 0.0 and gap > 50.0
            and torch.isfinite(lse_b).all()):
        raise AssertionError("beta at extreme tied logits: want O = 0 and a finite lse ~200 up")
    for b, h, h_kv, t, s, causal, d in RULE_FP32_CASES:
        q, k, v = _tied(gen, dev, b, h, h_kv, t, s, d)
        label = f"fp32 ({b},{h}q/{h_kv}kv,{t},{s},{d}) causal={causal}"
        for rule in ("beta", "none"):
            e, o, _ = _check_rule(flash_attention_fwd_fp32,
                                  lambda *a, **kw: flash_attention_fwd_plain(*a, precision="fp32",
                                                                             **kw),
                                  q, k, v, rule, label, JVP_EXACT_TOL, JVP_EXACT_TOL, rel=True,
                                  causal=causal)
            errs[f"flash_fwd_fp32_{rule}"] = max(errs[f"flash_fwd_fp32_{rule}"], e)
            if rule == "beta":
                off, _ = flash_attention_fwd_fp32(q, k, v, causal=causal, correction="beta",
                                                  tol=-math.inf)
                share = (o != off).any(-1).float().mean().item()
                log(f"[options] beta {label}: the rule fired on {share:.3f} of the rows")
                if not share > 0.0:
                    raise AssertionError(f"beta never fired at {label}")
    return errs


def _options_b1_paths(dev) -> tuple[dict, dict]:
    """The entry points a user calls with the rules: flash_attention_bf16
    (correction="beta" and "none") forward and backward at the train shape,
    against the plain forward and backward; flash_attention_fwd_fp32 under
    each rule at the DiT's shape at head dims 64 and 128. Each runs with
    every count at 0 first.
    Returns (the launches of each run, the gradients' max|diff|/max|plain|)."""
    gen = torch.Generator(device=dev).manual_seed(32)
    launches, grad_rel = {}, 0.0
    b, h, t = RULE_TRAIN
    for rule in ("beta", "none"):
        q, k, v = _tied(gen, dev, b, h, h, t, t, 64)
        do = torch.randn_like(q)
        leaves = [x.requires_grad_(True) for x in (q, k, v)]
        _reset_counts()
        o = flash_attention_bf16(*leaves, causal=True, correction=rule)
        grads = torch.autograd.grad(o, leaves, do)
        torch.cuda.synchronize()
        launches[f"train_{rule}"] = {n: c for n, c in _launch_counts().items() if c}
        with torch.no_grad():
            o_p, lse_p = flash_attention_fwd_plain(q, k, v, causal=True, correction=rule)
            want = flash_attention_bwd_plain(q, k, v, o_p, lse_p, do, causal=True, fast=True)
        err_o = (o - o_p).abs().max().item()
        rel = max(((g - w).abs().max() / w.abs().max()).item() for g, w in zip(grads, want))
        grad_rel = max(grad_rel, rel)
        log(f"[options] flash_attention_bf16(correction={rule!r}) ({b},{h},{t},64) causal: O "
            f"max|diff| {err_o:.3e} (tol {FLASH_O_TOL}), gradients max|diff|/max|plain| "
            f"{rel:.3e} (tol {BWD_FAST_TOL}), launches {launches[f'train_{rule}']}")
        if not (err_o <= FLASH_O_TOL and rel <= BWD_FAST_TOL):
            raise AssertionError(f"flash_attention_bf16(correction={rule!r}) disagrees with the "
                                 "plain forward and backward")
        if launches[f"train_{rule}"].get("flash_fwd") != 1:
            raise AssertionError(f"flash_attention_bf16(correction={rule!r}) launched "
                                 f"{launches[f'train_{rule}']}")
        del q, k, v, do, leaves, o, grads, o_p, lse_p, want
        for d, path in ((64, f"dit_{rule}"), (HEAD128, f"dit128_{rule}")):
            q, k, v = _tied(gen, dev, RULE_DIT[0], RULE_DIT[1], RULE_DIT[1], RULE_DIT[2],
                            RULE_DIT[2], d)
            _reset_counts()
            flash_attention_fwd_fp32(q, k, v, correction=rule)
            torch.cuda.synchronize()
            launches[path] = {n: c for n, c in _launch_counts().items() if c}
            if launches[path].get("flash_fwd_fp32") != 1:
                raise AssertionError(f"flash_attention_fwd_fp32(correction={rule!r}) at d={d} "
                                     f"launched {launches[path]}")
    return launches, grad_rel


def _options_b1_timing(dev) -> dict:
    """The rules against "eps" at the train shapes (bf16 inputs, the kernel
    alone) beside their plain version and SDPA, and the fp32 mode's at the
    DiT's shape at head dims 64 and 128 (whole calls, prep included) beside
    its plain version and SDPA on f32 inputs. The bounds are the rule's function's: the same bytes
    and products as "eps" (the pre-pass's second QK^T is the kernel's
    choice)."""
    gen = torch.Generator(device=dev).manual_seed(33)
    out = {f"flash_fwd{m}_{r}": {} for m in ("", "_fp32") for r in ("beta", "none")}
    for d in (64, HEAD128):
        b, h, t = RULE_TRAIN
        q, k, v = (x.to(torch.bfloat16) for x in _tied(gen, dev, b, h, h, t, t, d))
        o, lse = flash_attention_fwd(q, k, v, causal=True)
        flops = 2 * 2 * b * h * visible_pairs(t, t, True) * d
        bnd = bound(nbytes(q, k, v, o, lse), (flops, PEAK_BF16))
        lib_ms = device_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
        eps_ms = device_ms(lambda: flash_attention_fwd(q, k, v, causal=True))
        line = []
        for rule in ("beta", "none"):
            ms = device_ms(lambda: flash_attention_fwd(q, k, v, causal=True, correction=rule))
            plain_ms = device_ms(lambda: flash_attention_fwd_plain(q, k, v, causal=True,
                                                                   correction=rule), 2, 3)
            r = {"ms": ms, "plain_ms": plain_ms, "eps_ms": eps_ms, "library_ms": lib_ms, **bnd}
            tag = f"flash_fwd_{rule}"
            if d == 64:
                out[tag].update(r, shape=f"({b},{h},{t},{d}) causal, bf16 in")
            else:
                out[tag]["head_dim_128"] = r
            line.append(f"{rule} {ms:.4f} ms ({ms / eps_ms:.2f}x eps), plain {plain_ms:.4f} ms")
        log(f"[timing] flash_fwd rules ({b},{h},{t},{d}) causal, bf16 in: eps {eps_ms:.4f} ms, "
            + ", ".join(line) + f", sdpa {lib_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
            f"({bnd['bound_by']})")
        del q, k, v, o, lse

    def few(fn):  # one call a graph, two replays, as phase 19 times B1 fp32
        return device_ms(fn, calls=1, replays=2)

    b, h, t = RULE_DIT
    for d in (64, HEAD128):
        q, k, v = _tied(gen, dev, b, h, h, t, t, d)
        o, lse = flash_attention_fwd_fp32(q, k, v)
        bnd = bound(nbytes(q, k, v, o, lse), (6 * 2 * b * h * t * t * d, PEAK_TF32))
        lib_ms = few(lambda: F.scaled_dot_product_attention(q, k, v))
        eps_ms = few(lambda: flash_attention_fwd_fp32(q, k, v))
        line = []
        for rule in ("beta", "none"):
            ms = few(lambda: flash_attention_fwd_fp32(q, k, v, correction=rule))
            plain_ms = few(lambda: flash_attention_fwd_plain(q, k, v, correction=rule,
                                                             precision="fp32"))
            r = {"ms": ms, "plain_ms": plain_ms, "eps_ms": eps_ms, "library_ms": lib_ms, **bnd,
                 "shape": f"({b},{h},{t},{d}), the call with its prep launch"}
            if d == 64:
                out[f"flash_fwd_fp32_{rule}"].update(r)
            else:
                out[f"flash_fwd_fp32_{rule}"]["head_dim_128"] = r
            line.append(f"{rule} {ms:.4f} ms ({ms / eps_ms:.2f}x eps), plain {plain_ms:.4f} ms")
        log(f"[timing] flash_fwd_fp32 rules ({b},{h},{t},{d}): eps {eps_ms:.4f} ms, "
            + ", ".join(line) + f", sdpa f32 {lib_ms:.4f} ms, bound 3xTF32 "
            f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
        del q, k, v, o, lse
    for name, r in out.items():
        r["library_call"] = "F.scaled_dot_product_attention" + (
            ", f32 inputs" if "fp32" in name else "(is_causal=True), bf16")
    return out


def _options_b18(dev) -> tuple[float, dict]:
    """B18 at ANY_GROUPS against its plain version at ANY_SHAPES (f32 and
    bf16 outputs, twice for the same bits), then timed at each group beside
    group 128 and 64, the plain version and torch.matmul of the bf16 weight;
    the bound counts the scale bytes (4x group 128's at group 32). Returns
    (max|diff|, the row's numbers at ANY_GROUP with every shape's)."""
    gen = torch.Generator(device=dev).manual_seed(34)
    err, row = 0.0, {"by_shape": {}}
    for m, k, n in ANY_SHAPES:
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        w = torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
        wb = w.to(torch.bfloat16)
        lib_ms = device_ms(lambda: torch.matmul(x, wb))
        y = torch.matmul(x, wb)
        times = {}
        for group in ANY_GROUPS + (64, 128):
            q4 = quantize_weight_int4(w, group=group)
            x4 = F.pad(x, (0, 2 * q4.packed.shape[0] - k))
            label = f"m={m} k={k} n={n} group={group}"
            if group in ANY_GROUPS:
                err = max(err, _check_weight(
                    "int4_linear",
                    lambda dt: int4_weight_matmul(x4, q4.packed, q4.scale, group, out_dtype=dt),
                    lambda dt: int4_weight_matmul_plain(x4, q4.packed, q4.scale, group, dt),
                    label))
            times[group] = device_ms(lambda: int4_weight_matmul(x4, q4.packed, q4.scale, group))
            if group == ANY_GROUP:
                n_bytes = nbytes(x, y, q4.packed, q4.scale)
                r = {"ms": times[group], "library_ms": lib_ms,
                     "plain_ms": device_ms(lambda: int4_weight_matmul_plain(
                         x4, q4.packed, q4.scale, group), calls=2, replays=3),
                     **bound(n_bytes, (2 * m * k * n, PEAK_BF16)),
                     "scale_bytes": nbytes(q4.scale), "packed_bytes": nbytes(q4.packed)}
        r["ms_by_group"] = times
        row["by_shape"][f"m={m} k={k} n={n}"] = r
        log(f"[timing] int4_linear m={m} k={k} n={n}: " + ", ".join(
            f"group {g} {ms:.4f} ms" for g, ms in times.items())
            + f"; group {ANY_GROUP}: plain {r['plain_ms']:.4f} ms, bf16 torch.matmul "
            f"{lib_ms:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}; scales "
            f"{r['scale_bytes']} B beside {r['packed_bytes']} B of nibbles)")
    head = "m={} k={} n={}".format(*WEIGHT_HEADLINE)
    row.update(row["by_shape"][head], headline_shape=head, group=ANY_GROUP,
               library_call="torch.matmul(x, w) with the weight in bf16")
    return err, row


def _options_lm(dev, smi) -> dict:
    """The bench LM with quantize_lm_weights(bits=4, group=32,
    include_embed=False): one batched prefill of N_SLOTS prompts and
    LM_G32_NEW greedy decode steps through `generate` with every count at 0
    first (B18 must launch, at group 32), then the logits of prompt and
    continuation on the card against the plain path on the CPU. Returns the
    run's launches."""
    cfg = BENCH_CFG
    params = init_transformer(cfg, torch.Generator(device=dev).manual_seed(0), dev, torch.bfloat16)
    qp = quantize_lm_weights(params, include_embed=False, bits=4, group=ANY_GROUP)
    if isinstance(qp["embed"], QuantizedWeight) or qp["layers"][0]["w1"].group != ANY_GROUP:
        raise AssertionError("quantize_lm_weights ignored include_embed or group")
    rng = np.random.default_rng(31)
    prompts = torch.tensor(rng.integers(1, cfg.vocab_size, (N_SLOTS, 64)), device=dev)
    _reset_counts()
    with torch.no_grad():
        seq = generate(qp, prompts, cfg, LM_G32_NEW)
    torch.cuda.synchronize()
    launches = {n: c for n, c in _launch_counts().items() if c}
    with torch.no_grad():
        logits = transformer_forward(qp, seq, cfg).float().cpu()
        ref = transformer_forward(_to(qp, "cpu"), seq.cpu(), cfg).float()
    rel = ((logits - ref).norm() / ref.norm()).item()
    log(f"[options] bench LM, int4 weights at group {ANY_GROUP}, float embedding: "
        f"{N_SLOTS} x 64-token prefill + {LM_G32_NEW} decode steps on {smi}, launches {launches}; "
        f"logits vs CPU plain path rel L2 {rel:.3e} (tol {LOGITS_REL_TOL})")
    if not (torch.isfinite(logits).all() and rel <= LOGITS_REL_TOL):
        raise AssertionError("the group-32 LM's logits disagree with the plain CPU path")
    if not all(launches.get(n) for n in ("int4_linear", "flash_fwd", "decode")):
        raise AssertionError(f"the group-32 LM path launched {launches}")
    return launches


OPTION_ROWS = {  # phase 31's instances: the kernel each is a mode of
    "flash_fwd_beta": ("flash_fwd.cu", "correction='beta' of the B1 bf16 kernel (d 64 and 128)"),
    "flash_fwd_none": ("flash_fwd.cu", "correction='none' of the B1 bf16 kernel (d 64 and 128)"),
    "flash_fwd_fp32_beta": ("flash_fwd.cu", "correction='beta' of the B1 fp32 kernel (d 64 and "
                                            "128)"),
    "flash_fwd_fp32_none": ("flash_fwd.cu", "correction='none' of the B1 fp32 kernel (d 64 and "
                                            "128)"),
    "int4_linear_any": ("int4_linear.cu", "B18's ANY instances: groups that are not multiples "
                                          "of 64"),
}


def phase_options(dev, smi) -> list:
    """Phase 31: B1's "beta" and "none" rules (bf16 and fp32 at head dims 64
    and 128) and B18 at groups that are not multiples of 64, each against
    its plain version, on the paths a user calls them through, and timed.
    Returns the `kernels` line's rows of these instances."""
    errs = _options_b1(dev)
    launches, grad_rel = _options_b1_paths(dev)
    timing = _options_b1_timing(dev)
    b18_err, b18 = _options_b18(dev)
    lm = _options_lm(dev, smi)
    errs["int4_linear_any"] = b18_err
    timing["int4_linear_any"] = b18
    timing["flash_fwd_beta"]["grad_rel_vs_plain"] = grad_rel
    by_path = {"flash_fwd_beta": {"train_beta": launches["train_beta"]["flash_fwd"]},
               "flash_fwd_none": {"train_none": launches["train_none"]["flash_fwd"]},
               "flash_fwd_fp32_beta": {p: launches[p]["flash_fwd_fp32"]
                                       for p in ("dit_beta", "dit128_beta")},
               "flash_fwd_fp32_none": {p: launches[p]["flash_fwd_fp32"]
                                       for p in ("dit_none", "dit128_none")},
               "int4_linear_any": {"lm_w4_g32": lm["int4_linear"]}}
    rows = []
    for name, (source, mode) in OPTION_ROWS.items():
        replaces = ("quantizedattention_tpu/ops/int4_linear.py:64" if name.startswith("int4")
                    else "quantizedattention_tpu/ops/flash_fwd.py:47")
        rows.append({"name": name, "route": "cuda",
                     "source": f"quantizedattention_tpu_torch/csrc/{source}",
                     "replaces": replaces, "mode_of": mode, "launches_by_path": by_path[name],
                     "launches": sum(by_path[name].values()), "max_abs_err": errs[name],
                     **timing[name]})
    return rows


def main() -> None:
    name, smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    gen = torch.Generator(device=dev).manual_seed(0)
    flash = phase_flash(dev, gen)
    decode = phase_decode(dev, gen)
    serve_tokens, serve_launches = phase_serving(dev, smi)
    bwd_err = phase_flash_bwd(dev, gen)
    timing, train_err = phase_train_timing(dev, gen)
    int8_err = phase_int8_kernels(dev, gen)
    sdpa = {"fwd": timing["flash_fwd"]["library_ms"], "bwd": timing["flash_bwd_dq"]["library_ms"]}
    int8_timing = phase_int8_timing(dev, gen, sdpa)
    phase_int8_oracle(dev, gen)
    train_launches, bf16_run = phase_train(dev, smi, TRAIN_CFG)
    int8_launches, int8_run = phase_train(dev, smi, INT8_TRAIN_CFG)
    ratios = [a / b for a, b in zip(int8_run["grad_norms"], bf16_run["grad_norms"])]
    log(f"[train_int8] global grad norm int8 / bf16 per step: {[round(r, 4) for r in ratios]} "
        f"(limit {GRAD_NORM_RATIO}); median step {int8_run['median_ms']:.2f} ms vs "
        f"{bf16_run['median_ms']:.2f} ms; max_memory_allocated {int8_run['max_memory_gib']:.2f} "
        f"vs {bf16_run['max_memory_gib']:.2f} GiB")
    if not all(np.isfinite(ratios)) or max(ratios) >= GRAD_NORM_RATIO:
        raise AssertionError("int8 gradient norms left 2x the bf16 run's (BASELINE config 4)")
    gqa_launches = phase_train_gqa(dev, GQA_CFG)
    int8_gqa_launches = phase_train_gqa(dev, INT8_GQA_CFG)
    fused_err = phase_int8_fused(dev, gen)
    phase_int8_infer_oracle(dev, gen)
    fused, infer_launches = phase_int8_infer_timing(dev, gen)
    weights = phase_weight_kernels(dev, gen)
    quant_runs = phase_serving_quantized(dev, smi, serve_tokens, serve_launches)
    jvp_err = phase_jvp_kernels(dev, gen)
    oracle_launches = phase_jvp_oracle(dev, gen)
    jvp_timing = phase_jvp_timing(dev, gen)
    dit_launches, dit_jvp_launches, _ = phase_dit(dev, smi)
    caches = phase_cache_kernels(dev, gen)
    cache_runs = phase_serving_caches(dev, smi, serve_tokens, serve_launches)
    verify = phase_verify_kernels(dev, gen)
    spec_runs = phase_spec_serving(dev, smi)
    chunk_b1, chunk_runs = phase_chunked_prefix_serving(dev, gen, smi, serve_tokens)
    mesh_runs = phase_mesh_serving(dev, smi, gen)
    mesh_launches = {k: v for k, v in mesh_runs.items() if k.startswith("mesh_")
                     and k not in ("mesh_profile", "mesh_tokens_per_s", "mesh_local")}
    head128 = phase_head128(dev, smi)
    options = phase_options(dev, smi)
    sp, pool = phase_sp_training(dev, smi)
    try:
        rcm = phase_sp_rcm(dev, smi, pool)
        pipe = phase_pipeline(dev, smi, pool)
    finally:
        pool.close()
    sp_launches = {k: v for k, v in sp["launches"].items() if not k.endswith("_profile")}
    sp_launches.update(rcm["launches"])
    sp_launches.update(pipe["launches"])

    def at_train(name):
        return {f"train_{k}": v for k, v in timing[name].items()}

    kernels = [
        {"name": "flash_fwd", "route": "cuda",
         "source": "quantizedattention_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "quantizedattention_tpu/ops/flash_fwd.py:47",
         "launches_by_path": {"serve": serve_launches["flash_fwd"],
                              "train": train_launches["flash_fwd"],
                              "train_gqa": gqa_launches["flash_fwd"]},
         **flash, "max_abs_err": max(flash["max_abs_err"], train_err["flash_fwd"],
                                     chunk_b1["chunk_max_abs_err"]),
         **at_train("flash_fwd"), **chunk_b1},
        {"name": "decode", "route": "cuda",
         "source": "quantizedattention_tpu_torch/csrc/cache_decode.cu",
         "replaces": "quantizedattention_tpu/parallel/kv_cache.py:172",
         "launches_by_path": {"serve": serve_launches["decode"]}, **decode, **verify["decode"]},
    ]
    for kname, replaces in (("flash_bwd_dkv", "quantizedattention_tpu/ops/flash_bwd.py:66"),
                            ("flash_bwd_dq", "quantizedattention_tpu/ops/flash_bwd.py:132")):
        kernels.append({"name": kname, "route": "cuda",
                        "source": "quantizedattention_tpu_torch/csrc/flash_bwd.cu",
                        "replaces": replaces,
                        "launches_by_path": {"train": train_launches[kname],
                                             "train_gqa": gqa_launches[kname],
                                             "jvp_oracle": oracle_launches[kname]},
                        "max_abs_err": max(bwd_err[kname], train_err[kname]),
                        **timing[kname]})
    kernels[-2].update(  # fast mode's prep launches run in every B2/B3 call of the train paths
        also_runs="quantizedattention_tpu_torch/csrc/flash_bwd.cu bwd_prep_kernel (q_s, dO_s, lse "
                  "and D, once a fast call) and csrc/flash_fwd.cu kv_to_bf16_kernel (f32 K, V)",
        prep_launches_by_path={"train": train_launches["flash_bwd_prep"],
                               "train_gqa": gqa_launches["flash_bwd_prep"]})
    for kname, source, replaces in (
            ("quant_int8", "quant_int8.cu", "quantizedattention_tpu/quantize/int8.py:66"),
            ("int8_fwd", "int8_fwd.cu", "quantizedattention_tpu/ops/int8_fwd.py:68"),
            ("int8_bwd_dkv", "int8_bwd.cu", "quantizedattention_tpu/ops/int8_bwd.py:62"),
            ("int8_bwd_dq", "int8_bwd.cu", "quantizedattention_tpu/ops/int8_bwd.py:123")):
        kernels.append({"name": kname, "route": "cuda",
                        "source": f"quantizedattention_tpu_torch/csrc/{source}",
                        "replaces": replaces,
                        "launches_by_path": {"train_int8": int8_launches[kname],
                                             "train_gqa_int8": int8_gqa_launches[kname]},
                        "max_abs_err": int8_err[kname], **int8_timing[kname]})
    kernels[-4]["also_replaces"] = ["quantizedattention_tpu/quantize/int8.py:74",
                                    "quantizedattention_tpu/quantize/int8.py:85"]
    kernels.append({"name": "int8_fused", "route": "cuda",
                    "source": "quantizedattention_tpu_torch/csrc/int8_fwd.cu",
                    "also_runs": "quantizedattention_tpu_torch/csrc/quant_int8.cu (the payloads "
                                 "and scales of Q, K and V, once per call)",
                    "replaces": "quantizedattention_tpu/ops/int8_fwd.py:197",
                    "launches_by_path": {"infer_int8": infer_launches["int8_fused"]},
                    "max_abs_err": fused_err, **fused})
    for kname, replaces in (("int8_linear", "quantizedattention_tpu/ops/int8_linear.py:42"),
                            ("int4_linear", "quantizedattention_tpu/ops/int4_linear.py:64")):
        kernels.append({"name": kname, "route": "cuda",
                        "source": f"quantizedattention_tpu_torch/csrc/{kname}.cu",
                        "replaces": replaces, "launches_by_path": {}, **weights[kname]})
    for kname, source, replaces in (
            ("flash_fwd_fp32", "flash_fwd.cu", "quantizedattention_tpu/ops/flash_fwd.py:47"),
            ("jvp_fwd", "jvp.cu", "quantizedattention_tpu/ops/jvp_fwd.py:39"),
            ("jvp_tangent", "jvp.cu", "quantizedattention_tpu/ops/jvp_tangent.py:44"),
            ("jvp_bwd_dkv", "jvp.cu", "quantizedattention_tpu/ops/jvp_bwd.py:105"),
            ("jvp_bwd_dq", "jvp.cu", "quantizedattention_tpu/ops/jvp_bwd.py:155")):
        by_path = {"dit_rcm": dit_launches[kname], "jvp_oracle": oracle_launches[kname]}
        if dit_jvp_launches[kname]:
            by_path["dit_jvp"] = dit_jvp_launches[kname]
        kernels.append({"name": kname, "route": "cuda",
                        "source": f"quantizedattention_tpu_torch/csrc/{source}",
                        "replaces": replaces, "launches_by_path": by_path,
                        "max_abs_err": jvp_err[kname], **jvp_timing[kname]})
    kernels[-5]["mode_of"] = "precision='fp32' of the B1 kernel"
    kernels[-3]["also_runs"] = (
        "quantizedattention_tpu_torch/csrc/jvp.cu tangent_prep_kernel (K, tK, V and tV split into "
        "TF32 big and small parts, once an exact call) and tangent_merge_kernel (the key ranges' "
        "sums, in order, where the keys are split)")
    for row, prep, what in (
            (kernels[-5], "flash_fwd_fp32_prep", "csrc/flash_fwd.cu kv_split_tf32_kernel (K big and "
                                                 "small, V^T big and small, once a call)"),
            (kernels[-4], "jvp_fwd_prep", "csrc/jvp.cu jvp_fwd_prep_kernel (K, V, tK and tV in "
                                          "bf16 from the model's strided views, once a fast call)"),
            (kernels[-2], "jvp_bwd_prep", "csrc/jvp.cu jvp_bwd_prep_kernel (the eight operands in "
                                          "bf16 and the row terms, once a fast call, shared with "
                                          "B12)")):
        row["also_runs"] = f"quantizedattention_tpu_torch/{what}"
        row["prep_launches_by_path"] = {
            path: n for path, n in (("dit_rcm", dit_launches[prep]),
                                    ("jvp_oracle", oracle_launches[prep]),
                                    ("dit_jvp", dit_jvp_launches[prep])) if n}
    for kname, replaces in (("paged_decode", "quantizedattention_tpu/parallel/paged_cache.py:252"),
                            ("decode4", "quantizedattention_tpu/parallel/kv4_cache.py:341"),
                            ("paged4_decode",
                             "quantizedattention_tpu/parallel/paged4_cache.py:246")):
        kernels.append({"name": kname, "route": "cuda",
                        "source": "quantizedattention_tpu_torch/csrc/cache_decode.cu",
                        "replaces": replaces, "launches_by_path": {}, **caches[kname],
                        **verify[kname]})
    for k in kernels:  # the decode rows' error: the spec = 1 and verify phases'
        if "verify_max_abs_err" in k:
            k["max_abs_err"] = max(k["max_abs_err"], k["verify_max_abs_err"])
    for k in kernels:  # the quantized, cache-kind, spec, chunked and prefix runs' launches
        for path, counts in {**quant_runs, **cache_runs, **spec_runs, **chunk_runs,
                             **mesh_launches, **sp_launches}.items():
            if k["name"] in counts:
                k["launches_by_path"][path] = counts[k["name"]]
    for k in kernels:  # the kernels at one mesh rank's shapes (phase 26)
        if k["name"] in mesh_runs["mesh_local"]:
            k["mesh_rank"] = mesh_runs["mesh_local"][k["name"]]
            k["max_abs_err"] = max(k["max_abs_err"], k["mesh_rank"]["max_abs_err"])
    for k in kernels:  # the JVP preps on the sharded rCM path (phase 28)
        prep = {"jvp_fwd": "jvp_fwd_prep", "jvp_bwd_dkv": "jvp_bwd_prep"}.get(k["name"])
        if prep:
            k["prep_launches_by_path"]["dit_rcm_sp"] = rcm["launches"]["dit_rcm_sp"][prep]
    for k in kernels:  # B1-B3, B5, B7, B8 at the SP shard shapes with global offsets (phase 27)
        if k["name"] in sp["errs"]:
            k["sp_cases"] = sp["times"][k["name"]]
            k["max_abs_err"] = max(k["max_abs_err"], sp["errs"][k["name"]])
    for k in kernels:  # B1-B3 at the pipeline's microbatch shape, B2's prep on its path (phase 29)
        if k["name"] in pipe["times"]:
            k["pipe_microbatch"] = pipe["times"][k["name"]]
            k["max_abs_err"] = max(k["max_abs_err"], pipe["errs"][k["name"]])
        if k["name"] == "flash_bwd_dkv":
            k["prep_launches_by_path"]["train_pipe"] = pipe["launches"]["train_pipe"][
                "flash_bwd_prep"]
    _head128_rows(kernels, head128)  # B1-B3 and B13 at head dim 128 (phase 30)
    for k in kernels:  # launches: every path's run together
        k["launches"] = sum(k["launches_by_path"].values())
    kernels += options  # B1's rules and B18's ANY instances (phase 31)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


# --------------------------------------------------------------------------
# The SP cost model's constants on four cards (`python3 chip_smoke.py sp_model`)
# --------------------------------------------------------------------------

# context 4 over the ranks: TRAIN_CFG's 16 heads divide it, so every strategy
# runs (Ulysses, and zigzag's 2 x 4 chunks of 256 and 1024 tokens); max_seq
# 2048 and 8192 (t_local 512 and 2048) on both sides of the ring/all-gather
# crossover the model predicts
SP_MODEL_SHAPE, SP_MODEL_SEQS = (1, 1, SP_RANKS), (2048, 8192)
SP_MODEL_WARMUP, SP_MODEL_STEPS = 2, 5
# the JAX module's rate anchor: (b, h, t, d), causal
SP_MODEL_ANCHOR = (4, 16, 4096, 64)


def _sp_model_rates(dev) -> dict:
    """The kernels' rates at SP_MODEL_ANCHOR, as the JAX module's
    MEASURED_RATES are taken: attention_flops over the time of a forward
    (bf16: B1, `flash_attention_bf16`; int8: `sage_attention_int8`, its K
    mean, B4 and B5) and of a backward (bf16: the fast
    `flash_attention_bwd`, its prep, B2 and B3; int8: B7 + B8), the
    backward's rate as 2.5 x the forward's FLOPs over its time. q and dO in
    f32 as the model hands them, K and V in bf16 as they ride the ring
    (f32 for int8, which quantizes them). CUDA-graph replays
    (utils/profiling.py)."""
    from quantizedattention_tpu_torch.parallel.scaling_model import _BWD_FLOPS_FACTOR
    from quantizedattention_tpu_torch.utils.profiling import (attention_flops, graph_seconds,
                                                              time_attention)

    b, h, t, d = SP_MODEL_ANCHOR
    g = torch.Generator(device=dev).manual_seed(24)
    q, k, v, do = (torch.randn((b, h, t, d), generator=g, device=dev) for _ in range(4))
    k16, v16 = k.to(torch.bfloat16), v.to(torch.bfloat16)
    flops = attention_flops(b, h, t, t, d, True)
    with torch.no_grad():
        fwd = {"bf16": time_attention(lambda q, k, v: flash_attention_bf16(q, k, v, causal=True),
                                      q, k16, v16, True, "bf16"),
               "int8": time_attention(lambda q, k, v: sage_attention_int8(q, k, v, causal=True),
                                      q, k, v, True, "int8")}
        o, lse = flash_attention_fwd(q, k16, v16, causal=True)
        bwd = {"bf16": graph_seconds(
            lambda *x: flash_attention_bwd(*x, causal=True, fast=True), q, k16, v16, o, lse, do)}
        k_mean = k.mean(dim=-2, keepdim=True)
        res = quantize_qkv(q, k, v, k_sub=k_mean)
        dims = (b, h, t, t, d)
        o8, lse8 = int8_attention_fwd_from_quantized(res, dims, causal=True)
        ops = int8_bwd_operands(res, k_mean, o8, lse8, do, dims, causal=True)
        bwd["int8"] = graph_seconds(lambda x: (int8_bwd_dkv(ops), int8_bwd_dq(ops)), ops.do)
    rates = {}
    for kind in ("bf16", "int8"):
        rates[kind, "fwd"] = flops / fwd[kind].seconds
        rates[kind, "bwd"] = _BWD_FLOPS_FACTOR * flops / bwd[kind]
        log(f"[sp_model] {kind} at {SP_MODEL_ANCHOR} causal: forward {fwd[kind]} -> "
            f"{rates[kind, 'fwd']:.4e} FLOP/s; backward {bwd[kind] * 1e3:.4f} ms -> "
            f"{rates[kind, 'bwd']:.4e} FLOP/s (2.5 x {flops:.4e} FLOPs)")
    del q, k, v, do, k16, v16, o, lse, res, o8, lse8, ops
    torch.cuda.empty_cache()
    return rates


def _sp_model_link(pool) -> tuple[dict, dict]:
    """models/sharded_jobs.py:link_bench on the pool (a K/V shard pair of
    TRAIN_CFG at each SP_MODEL_SEQS length, and 1 KB). Returns (its rows,
    the model's link constants: the hop's bytes a second on the longest
    shard, the hop's time at 1 KB, the mean of the blocking collectives'
    times at 1 KB)."""
    from quantizedattention_tpu_torch.models import sharded_jobs

    shards = [(TRAIN_BATCH, TRAIN_CFG.n_kv_heads, seq // SP_RANKS, TRAIN_CFG.head_dim)
              for seq in SP_MODEL_SEQS]
    link = pool.run(sharded_jobs.link_bench, shards)[0]
    for key, r in link.items():
        log(f"[sp_model] link {key}: {r['ms'] * 1e3:.2f} us a call, payload "
            f"{r['payload_bytes']} B, {r['bytes']:.0f} B sent a device, "
            f"{r['bytes_per_s']:.4e} B/s")
    consts = {"link_bytes_per_s": link[f"hop_t{shards[-1][2]}"]["bytes_per_s"],
              "hop_latency_s": link["hop_latency"]["ms"] / 1e3,
              "collective_latency_s": statistics.mean(
                  link[f"{op}_latency"]["ms"] for op in ("all_gather", "psum_scatter",
                                                         "all_to_all")) / 1e3}
    return link, consts


def _sp_model_steps(pool, smi) -> dict:
    """The steady step (models/sharded_jobs.py:steady_train) of every
    strategy at TRAIN_CFG on SP_MODEL_SHAPE, at each SP_MODEL_SEQS length,
    bf16 and int8. Returns {(seq, kind): {strategy: rank 0's result}}."""
    from quantizedattention_tpu_torch.models import sharded_jobs
    from quantizedattention_tpu_torch.models.sharded_train import STRATEGIES

    out = {}
    for seq in SP_MODEL_SEQS:
        rng = np.random.default_rng(seq)
        tokens = torch.from_numpy(rng.integers(0, TRAIN_CFG.vocab_size, (TRAIN_BATCH, seq)))
        targets = torch.roll(tokens, -1, dims=1)
        for kind in ("bf16", "int8"):
            cfg = dataclasses.replace(TRAIN_CFG, max_seq=seq, attention=kind)
            for sp in STRATEGIES:
                outs = pool.run(sharded_jobs.steady_train, cfg, SP_MODEL_SHAPE, tokens,
                                targets, kind, sp, SP_MODEL_WARMUP, SP_MODEL_STEPS, "cuda")
                r = {**outs[0], "profile": outs[-1]["profile"]}
                if set(r["ran"]) != {sp} or not np.isfinite(r["losses"]).all():
                    raise AssertionError(f"[sp_model] {sp} {kind} at {seq}: ran {r['ran']}, "
                                         f"losses {r['losses']}")
                p = r["profile"]
                log(f"[sp_model] {sp} {kind}, max_seq {seq}, mesh {SP_MODEL_SHAPE} on {smi} "
                    f"({r['backend']}): steps (rank 0, CUDA events) "
                    f"{[round(x, 3) for x in r['step_ms']]} ms, median {r['median_ms']:.3f}; "
                    f"one profiled step on the last rank: wall {p['wall_ms']:.2f}, device "
                    f"{p['device_ms']:.2f} "
                    f"ms (busy {p['busy_share']:.1%}); attention kernels "
                    f"{p['attention_ms']:.3f} ms, NCCL kernels {p['nccl_ms']:.3f} ms, of which "
                    f"{p['nccl_under_attention_ms']:.3f} ms under an attention kernel; top "
                    f"{[(n, round(ms, 3), c) for n, ms, c in p['top_device'][:5]]}")
                out[seq, kind, sp] = r
    return out


def _sp_model_report(rates, consts, steps) -> list:
    """The model under the measured constants against the card at each
    (max_seq, kind): each strategy's predicted attention time a step
    (predict_step x n_layers) beside its measured median step and attention
    kernels' device time, the differences from the ring on both sides, the
    model's pick (best_sp_variant on auto_sp_arguments) and the measured
    fastest. Reported, not gated: a step is mostly fp32 GEMMs, so the
    strategies' differences in step time are what the model's differences
    in attention time should predict."""
    from quantizedattention_tpu_torch.models.sharded_train import STRATEGIES, auto_sp_arguments
    from quantizedattention_tpu_torch.parallel.scaling_model import (SPWorkload,
                                                                     best_sp_variant,
                                                                     predict_step)

    points = []
    for seq in SP_MODEL_SEQS:
        for kind in ("bf16", "int8"):
            cfg = dataclasses.replace(TRAIN_CFG, max_seq=seq, attention=kind)
            args = auto_sp_arguments(cfg, SP_MODEL_SHAPE[1], SP_MODEL_SHAPE[2], kind)
            w = SPWorkload(b=TRAIN_BATCH, h=args["h"], h_kv=args["h_kv"], t_local=seq // SP_RANKS,
                           d=args["d"], n=args["n"], kind=kind)
            rows = {}
            for sp in STRATEGIES:
                pred = predict_step(w, sp, rates=rates, **consts)
                r = steps[seq, kind, sp]
                rows[sp] = {"model_ms": pred.t_step_s * cfg.n_layers * 1e3,
                            "model_comp_ms": pred.t_comp_s * cfg.n_layers * 1e3,
                            "model_comm_ms": pred.t_comm_s * cfg.n_layers * 1e3,
                            "step_ms": r["median_ms"],
                            "attention_ms": r["profile"]["attention_ms"],
                            "nccl_ms": r["profile"]["nccl_ms"],
                            "nccl_under_attention_ms": r["profile"]["nccl_under_attention_ms"]}
            pick = best_sp_variant(**args, rates=rates, **consts)
            fastest = min(rows, key=lambda sp: rows[sp]["step_ms"])
            for sp, row in rows.items():
                row["model_vs_ring_ms"] = row["model_ms"] - rows["ring"]["model_ms"]
                row["step_vs_ring_ms"] = row["step_ms"] - rows["ring"]["step_ms"]
                log(f"[sp_model] max_seq {seq} {kind} {sp:9s}: model {row['model_ms']:8.3f} ms "
                    f"of attention a step (compute {row['model_comp_ms']:.3f}, link "
                    f"{row['model_comm_ms']:.3f}; {row['model_vs_ring_ms']:+.3f} vs the ring) | "
                    f"card: step {row['step_ms']:8.3f} ms ({row['step_vs_ring_ms']:+.3f} vs the "
                    f"ring), attention kernels {row['attention_ms']:.3f} ms, NCCL "
                    f"{row['nccl_ms']:.3f} ms ({row['nccl_under_attention_ms']:.3f} under "
                    f"attention)")
            gap = rows[pick]["step_ms"] - rows[fastest]["step_ms"]
            log(f"[sp_model] max_seq {seq} {kind}: the model picks {pick!r}, the card's fastest "
                f"is {fastest!r}; the pick's step is {gap:.3f} ms slower than the fastest's")
            points.append({"max_seq": seq, "kind": kind, "pick": pick, "fastest": fastest,
                           "pick_minus_fastest_ms": gap, "strategies": rows})
    return points


def main_sp_model() -> None:
    """`python3 chip_smoke.py sp_model`: phases 1 and 2, then the SP cost
    model's constants on four cards, one rank a card over NCCL (refused on
    fewer: ranks sharing a card over gloo time the host, not the links):
    `nvidia-smi topo -m`, `nvlink --status` and peer access; the kernels'
    rates at the JAX module's anchor; the port's hop and collectives
    (link_bench); the steady step of every
    strategy at TRAIN_CFG on (1, 1, 4), max_seq 2048 and 8192, bf16 and
    int8, with one profiled step each; then the model under the measured
    constants against the card. The last line but one holds the constants,
    the link rows and every point."""
    from quantizedattention_tpu_torch.parallel.launch import RankPool

    name, smi = phase_device()
    cards = torch.cuda.device_count()
    if cards < SP_RANKS:
        sys.exit(f"chip_smoke sp_model: needs {SP_RANKS} visible cards (one rank a card over "
                 f"NCCL); {cards} visible, and ranks sharing a card time the host, not links")
    phase_build()
    for cmd in (["nvidia-smi", "topo", "-m"], ["nvidia-smi", "nvlink", "--status"]):
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
        log(f"[sp_model] {' '.join(cmd)} (exit {r.returncode}):\n{r.stdout}{r.stderr}")
    peers = [[int(i == j or torch.cuda.can_device_access_peer(i, j)) for j in range(cards)]
             for i in range(cards)]
    log(f"[sp_model] peer access (torch.cuda.can_device_access_peer), card by card: {peers}")
    rates = _sp_model_rates(torch.device("cuda", 0))
    pool = RankPool(SP_RANKS, "cuda", timeout_s=900)
    try:
        if pool.backend != "nccl":
            raise AssertionError(f"[sp_model] the ranks run {pool.backend}, not NCCL")
        link, consts = _sp_model_link(pool)
        steps = _sp_model_steps(pool, smi)
    finally:
        pool.close()
    log(f"[sp_model] constants on {smi}: LINK_BYTES_PER_S {consts['link_bytes_per_s']:.4e}, "
        f"HOP_LATENCY_S {consts['hop_latency_s']:.4e}, COLLECTIVE_LATENCY_S "
        f"{consts['collective_latency_s']:.4e}, MEASURED_RATES "
        f"{ {f'{k[0]},{k[1]}': float(f'{r:.4e}') for k, r in rates.items()} }")
    points = _sp_model_report(rates, consts, steps)
    print(json.dumps({"sp_model": {"card": smi, "constants": consts,
                                   "rates": {f"{k[0]},{k[1]}": r for k, r in rates.items()},
                                   "link": link, "points": points}}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


HEAD128_ROWS = {  # phase 30's kernels: source and the TPU kernel each replaces
    "flash_fwd": ("flash_fwd.cu", "quantizedattention_tpu/ops/flash_fwd.py:47"),
    "flash_bwd_dkv": ("flash_bwd.cu", "quantizedattention_tpu/ops/flash_bwd.py:66"),
    "flash_bwd_dq": ("flash_bwd.cu", "quantizedattention_tpu/ops/flash_bwd.py:132"),
    "decode": ("cache_decode.cu", "quantizedattention_tpu/parallel/kv_cache.py:172"),
    "quant_int8": ("quant_int8.cu", "quantizedattention_tpu/quantize/int8.py:66"),
    "int8_fwd": ("int8_fwd.cu", "quantizedattention_tpu/ops/int8_fwd.py:68"),
    "int8_bwd_dkv": ("int8_bwd.cu", "quantizedattention_tpu/ops/int8_bwd.py:62"),
    "int8_bwd_dq": ("int8_bwd.cu", "quantizedattention_tpu/ops/int8_bwd.py:123"),
    "int8_fused": ("int8_fwd.cu", "quantizedattention_tpu/ops/int8_fwd.py:197"),
    "paged_decode": ("cache_decode.cu", "quantizedattention_tpu/parallel/paged_cache.py:252"),
    "flash_fwd_fp32": ("flash_fwd.cu", "quantizedattention_tpu/ops/flash_fwd.py:47"),
    "jvp_fwd": ("jvp.cu", "quantizedattention_tpu/ops/jvp_fwd.py:39"),
    "jvp_tangent": ("jvp.cu", "quantizedattention_tpu/ops/jvp_tangent.py:44"),
    "jvp_bwd_dkv": ("jvp.cu", "quantizedattention_tpu/ops/jvp_bwd.py:105"),
    "jvp_bwd_dq": ("jvp.cu", "quantizedattention_tpu/ops/jvp_bwd.py:155"),
    "decode4": ("cache_decode.cu", "quantizedattention_tpu/parallel/kv4_cache.py:341"),
    "paged4_decode": ("cache_decode.cu", "quantizedattention_tpu/parallel/paged4_cache.py:246"),
}


def main_head128() -> None:
    """`python3 chip_smoke.py head128`: phases 1, 2 and 30 alone; the
    `kernels` line holds the seventeen kernels and modes at head dim 128 (B1
    in both modes, B2-B16; the exact modes of B2/B3 and B9-B12 inside their
    kernels' rows)."""
    name, smi = phase_device()
    phase_build()
    head128 = phase_head128(torch.device("cuda", 0), smi, alone=True)
    kernels = []
    for kname, (source, replaces) in HEAD128_ROWS.items():
        row = dict(head128[kname])
        by_path = row.pop("launches_by_path")
        kernels.append({"name": kname, "route": "cuda",
                        "source": f"quantizedattention_tpu_torch/csrc/{source}",
                        "replaces": replaces, "launches_by_path": by_path,
                        "launches": sum(by_path.values()), **row})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


def main_options() -> None:
    """`python3 chip_smoke.py options`: phases 1, 2 and 31 alone; the
    `kernels` line holds B1's "beta" and "none" instances (both modes) and
    B18's ANY instances."""
    name, smi = phase_device()
    phase_build()
    kernels = phase_options(torch.device("cuda", 0), smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


def main_pipeline() -> None:
    """`python3 chip_smoke.py pipeline`: phases 1, 2 and 29 alone, phase 29
    on a pool of its own (on four visible cards, one rank a card over
    NCCL)."""
    from quantizedattention_tpu_torch.parallel.launch import RankPool

    name, smi = phase_device()
    phase_build()
    pool = RankPool(SP_RANKS, "cuda", timeout_s=600)
    try:
        pipe = phase_pipeline(torch.device("cuda", 0), smi, pool)
    finally:
        pool.close()
    print(json.dumps({k: v for k, v in pipe.items() if k != "times"}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["pipeline"]:
        main_pipeline()
    elif sys.argv[1:] == ["head128"]:
        main_head128()
    elif sys.argv[1:] == ["sp_model"]:
        main_sp_model()
    elif sys.argv[1:] == ["options"]:
        main_options()
    elif sys.argv[1:]:
        sys.exit(f"usage: python3 chip_smoke.py [pipeline | head128 | sp_model | options]; "
                 f"got {sys.argv[1:]}")
    else:
        main()
