#!/usr/bin/env python3
"""Drive the PyTorch port (apex_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

  1. device      the card's name and power limit, as nvidia-smi gives
                 them; the kernels are built from this checkout's
                 sources (nvcc for the CUDA C++, Triton's JIT); ptxas'
                 registers and spills by kernel, the flash backward's
                 and the dq pass's dynamic shared memory and any
                 serialised-wgmma note (C7512, C7515, C7518, C7520) are
                 logged; the dq pass's sixteen kernels must have no
                 spills and no such note, the 36 dropout instantiations
                 of the flash kernels no spill and no such note that
                 their rate-0 twins lack, the 24 fp32-output
                 instantiations of the backward kernels (the fused
                 kernel, the dk/dv pass, the dq pass) no spill and no
                 such note that their bf16 twins lack, nor the fused
                 dense GEMM's fp32 and
                 GEMV kernels any spill (their registers and spills in
                 its summary line, by kernel family), nor any kernel of
                 the LayerNorm forward and backward, flash-decode or
                 the channel sums (a summary line each: registers by
                 kernel, spills).
  2. kernels     each hand-written kernel against its plain PyTorch
                 version on the card, at the shapes the serving and
                 training paths give it, plus ragged cases: flash-decode
                 at the serving shape (its plan: no split, a one-row
                 tile; heads_per_step 1, 2 and 4 bit for bit with it,
                 8 and 16, which the plan splits, against the plain
                 version),
                 at 4 slots x 4096 keys (a split among a cluster's
                 blocks), GQA with q_len 2 and a page-8 case, each run
                 twice bit for bit; the LayerNorm forward at every
                 main-path shape (decode's 64 rows to GPT-1.3B's (3584,
                 2048)), RMSNorm, no weight, fp16, row-strided views,
                 4- and 2-byte rows and the 12-warp rows, each run twice
                 bit for bit; the LayerNorm backward at GPT's and
                 BERT's rows, ragged and tiny ones, fp16, RMSNorm, no
                 weight, 4- and 2-byte loads and rows of 2-12 warps, each
                 run twice bit for bit; the
                 segment-masked flash kernels at BERT's (32, 16, 512, 64)
                 with ragged padding, causal, and whole masked rows,
                 at sq != sk with sk off the backward's 128-key tile
                 (dk, dv of the fused kernel, the dk/dv pass and the
                 packed kernel bit for bit), at head_dim 128 with
                 BERT's padding and a dead row, each backward run twice
                 (dk, dv the same bits, each run's dq within
                 tolerance); the split backward's dq pass against its
                 plain version at the sq != sk shapes, at head_dim 128
                 with the padding and the dead row, at BERT's step shape
                 with its padding (causal and not) and with q/kv ids
                 that mask whole rows, two runs bit for bit each; the
                 LAMB kernels over the BERT-Large flat buffer in bf16 and
                 fp32, with a found_inf step and per-tensor lr scales;
                 the cross-entropy kernels at ResNet's (256, 1000) and a
                 ragged (64, 50304); SGD over the ResNet-50 flat buffer
                 (every flag, a first and a found_inf step); the channel
                 sums at each of ResNet-50's batch-norm shapes (bf16;
                 the first and last also fp32 and fp16), C = 3, fp64 and
                 an x off 16 bytes against fp64 sums, twice bit for bit; the softmax pair at GPT's causal
                 (192, 1024, 1024) and BERT's (32, 16, 512, 512) with a
                 ragged (32, 1, 1, 512) padding mask (8 sequences padded
                 entirely: uniform rows) in bf16 (the forward's loads 16
                 bytes wide in its PTX), in fp32 at ragged widths up to
                 20000, past the single-block cap, and with scaled
                 scores near -10000 (causal, BERT's padding, a chunked
                 row), where the masked elements' term of the sum
                 matters; the
                 segmented Adam over the GPT-350M flat buffer in bf16
                 and fp32 (the no-decay wd, lr scales, AdamW and L2, a
                 found_inf step), bit for bit; Adagrad over the same
                 buffer (bf16 and fp32 grads, L2 and decoupled weight
                 decay, wd 0 and 0.01), bit for bit; the per-element
                 LAMB phase 2 over the BERT-Large buffer in bf16 and
                 fp32, bit for bit with its plain version and with the
                 segmented phase 2 on the same ratios; the fused dense
                 GEMM in bf16, fp16 and fp32, every activation with and
                 without a bias, at GPT-350M's MLP shapes, apex's
                 run_mlp layers, an N = 8 router-like shape and ragged
                 shapes (N = 1 and N = 3 on the GEMV kernel), within
                 1e-2 (16-bit) or 1e-5 (fp32) of the largest |y|, each
                 call on the route the rule names (the fp32 kernel at
                 1024 x 512 x 256 with K split in one wave of clusters,
                 4-byte loads where K or N is not a multiple of 4), the
                 fp32 and GEMV kernels twice with the same bits; the
                 head-packed flash pair at heads_per_step 2 and
                 4 (GPT's causal step shape on its views, BERT's with
                 ragged padding and with q/kv ids that mask whole rows,
                 head_dim 128, and padding at 8256 keys, past the
                 forward's resident key ids): o, lse, dk and dv bit for
                 bit with the
                 hp=1 kernels, dq within one bf16 ulp of its largest
                 magnitude, every output against the plain version as
                 the hp=1 kernels are held; through the entry point, the
                 packed forward with the unpacked fused backward (hp=16
                 at (8, 16, 2048, 64), past the packed cap) and with the
                 split backward (hp=2 at (1, 8, 32768, 64)), against
                 hp=1; the flash kernels with in-kernel dropout: each
                 kernel's keep mask read back (v = I, do = I; k = I for
                 dq) bit for bit `dropout_keep_dense` at rates 0.1 and
                 0.5, q_off 0 and 4096, head_dim 64 and 128; then at
                 rates 0.1 and 0.5 the forward, the fused backward and
                 the packed pair at GPT's causal (12, 16, 1024, 64) on
                 its views, non-causal (8, 16, 2048, 64), head_dim 128,
                 BERT's (32, 16, 512, 64) with ragged padding, the split
                 pair at (1, 16, 8192, 64) causal and q_off 4096: o, dq,
                 dk, dv against the plain versions within the rate-0
                 tolerances, lse bit for bit rate 0's, each run twice
                 for the same bits, hp 2 and 4 bit for bit hp 1 (o,
                 lse, dk, dv), the dk/dv pass bit for bit the fused
                 kernel; the generic elementwise launcher with an axpy
                 and an Adam-shaped body over 1e8 + 37 fp32 elements,
                 bit for bit with their plain versions; the segmented
                 Adam, LAMB phase 1 and phase 2 on four virtual ZeRO
                 shards of GPT-350M's and BERT-Large's flat buffers (bf16,
                 tensors straddling the edges), each shard at its row
                 offset bit for bit its plain version, the shards'
                 concatenation bit for bit one whole-buffer launch, the
                 shards' per-tensor sums of squares summed in rank order
                 within 1e-5 relative of the whole buffer's (the same
                 bits on a second run), one shard's time beside the
                 whole buffer's; the backward kernels with fp32 outputs
                 (the ring's chunk backward) at the ring's chunk shapes
                 (1, 8, 4096 / 8192 / 16384, 64) causal and not, sq !=
                 sk off the tile, head_dim 128 with padding and a dead
                 row, dropout 0.1 at q_off / k_off 8192 / 4096: the
                 bf16 launches' dk, dv and the dq pass's dq equal the
                 fp32 ones rounded, bit for bit, each fp32 launch twice
                 the same bits (the fused kernel's dq within
                 tolerance), the dk/dv pass's the fused kernel's, every
                 fp32 output against the plain versions with fp32
                 outputs within 1e-2 of its largest magnitude.
  3. engine      the flagship serving path at full width: GPT-350M in
                 bf16 (random weights, seed 0), 64 slots, 64 requests
                 with the bench's ragged prompts (1..128 tokens) and 32
                 new tokens each, driven by `measure_decode`; the
                 kernels' launch counters prove the path ran through
                 them; one profiled window of pure decode steps: wall
                 and device ms a step, flash-decode's share.
  4. churn       8 ragged requests through a 4-slot engine of the same
                 model equal, bitwise, the same 8 decoded one at a time;
                 one decode step with the kernels agrees with the same
                 step through the plain versions.
  5. train       the training step at full width: GPT-350M in bf16
                 (seed-0 weights), batch 12 x seq 1024, bf16 logits,
                 FusedAdam(lr=1e-4, master_dtype=bf16), 5 steps on one
                 seeded batch; the loss is finite and falls, the launch
                 counters prove every step ran 24 flash forwards and
                 backwards, 49 LayerNorm forwards and backwards and one
                 Adam; tokens/s, peak memory and one profiled step.  One
                 step through the kernels agrees with the same step
                 through the plain versions (full width, 2 layers,
                 batch 2).
  6. bert        the BERT-Large pretraining step at full width: bf16
                 (seed-0 weights), batch 32 x seq 512, fp32 MLM logits,
                 MLM + NSP, FusedLAMB(lr=1e-4, wd 0.01, master bf16) with
                 the no-decay wd_mask, 5 steps on the bench's seeded
                 batch; the loss is finite and falls, the launch counters
                 prove every step ran 24 flash forwards and backwards,
                 50 LayerNorm forwards and backwards, one LAMB phase 1,
                 two per-tensor norms and one phase 2, with no host
                 sync; sequences/s, peak memory and one profiled step;
                 two steps of FusedLAMB without a mask (its phase 1
                 without segments).  One step through the kernels agrees
                 with the same step through the plain versions (full
                 width, 2 layers, batch 2, ragged padding).
  7. resnet      the ResNet-50 AMP-O1 training step at full width
                 (`bench.py:338-391`): seed-0 weights, batch 256 of
                 224x224x3 seeded images, amp O1, the mean fp32 cross
                 entropy, FusedSGD(0.1, 0.9, 1e-4), `make_train_step(
                 with_state=True)`, cuDNN's algorithm search on; two
                 warm-up and five timed steps on one batch; the loss is
                 finite and falls, no step overflows, the launch counters
                 prove every step ran 53 channel sums, one cross-entropy
                 forward and backward and one SGD, with no host sync;
                 img/s, peak memory and one profiled step, with the
                 channel sums' device ms in it beside the bound of their
                 53 inputs' bytes.  One step
                 through the kernels agrees with the same step through
                 the plain versions (full width, batch 8).
  8. dense       GPT-350M's default dense-attention step at full width
                 (phase 5's configuration with use_flash_attention=False
                 and FusedAdam(lr=1e-4, weight_decay=0.01, master bf16)
                 with the no-decay wd_mask), two warm-up and five timed
                 steps on one seeded batch; the loss is finite and falls,
                 the launch counters prove every step ran 24 softmax
                 forwards and backwards, 49 LayerNorm forwards and
                 backwards, one segmented Adam and no flash kernel or
                 uniform Adam, with no host sync; tokens/s, peak memory
                 and one profiled step.  Then three BERT-Large steps of
                 phase 6's step with its default dense attention (24
                 masked softmax forwards and backwards a step, no
                 flash), with no host sync: sequences/s, peak memory
                 and one profiled step.  A 2-layer step of
                 each through the kernels agrees with the same step
                 through the plain versions (full width, batch 2; BERT
                 with ragged padding).
  9. long        the long-context backward, which takes the split route
                 (the dq pass, then the dk/dv pass) where sk * d > 256k:
                 both kernels against their plain versions, against
                 autograd through `attention_reference` and against the
                 fused kernel (dk, dv bit for bit) at (1, 8, 8192, 64 and
                 128), causal and not, and at (4, 8, 4608, 64) with
                 BERT's ragged padding (one sequence all padding), the dq
                 pass twice bit for bit; bench.py's `_long_context_32k`
                 at (1, 8, 32768, 64) bf16 causal through the entry point
                 and autograd, one warm-up and five timed iterations
                 (ms, tokens/s, peak memory; one forward, one dq and one
                 dk/dv launch an iteration, no fused backward; dk, dv
                 bit for bit with the fused kernel's on the same inputs,
                 dq within 1e-2 of its largest magnitude); the GPT-350M
                 step at seq 8192 (`gpt_350m(seq_len=8192)`, batch 1,
                 bf16 logits, FusedAdam(lr=1e-4, master bf16)), two
                 warm-up and three timed steps on one seeded batch: the
                 loss is finite and falls, every step runs 24 flash
                 forwards, 24 dq and 24 dk/dv passes and no fused
                 backward, 49 LayerNorm forwards and backwards and one
                 Adam, with no host sync; tokens/s, peak memory, one
                 profiled step, and a 2-layer step through the kernels
                 against the plain step (batch 1, seq 8192).  Then both
                 routes timed at 32k and at GPT's (12, 16, 1024, 64).
 10. slice 7     phase 5's flash GPT-350M step with FusedAdagrad(lr=1e-3)
                 through `make_tp_dp_train_step`, two warm-up and three
                 timed steps: the loss falls, every step runs 24 flash
                 forwards and backwards, 49 LayerNorm forwards and
                 backwards, one Adagrad and no Adam, with no host sync;
                 tokens/s, peak memory, one profiled step and a 2-layer
                 kernels-vs-plain step.  Phase 7's ResNet-50 AMP-O1 step
                 with LARC(FusedSGD(0.1, 0.9, 1e-4), trust 0.02, clip),
                 two warm-up and three timed steps: one SGD, two
                 per-tensor norm passes (params and grads), 53 channel
                 sums and one cross-entropy forward and backward a step,
                 no host sync, the loss falls; img/s, peak memory.
                 Phase 6's BERT-Large step with FusedNovoGrad(lr=1e-3,
                 betas (0.95, 0.98), wd 0.01, grad_averaging), two
                 warm-up and three timed steps: one per-tensor norm pass
                 and no LAMB kernel a step, no host sync, the loss
                 falls; seq/s.  FusedDenseGeluDense(1024, 4096, 1024) in
                 bf16 over (12288, 1024) tokens and MLP([480, 1024,
                 1024, 512, 256, 1], relu) at batch 1024 in fp32 and
                 bf16, forward and backward: two (five) GEMM launches a
                 forward, by route (the MLP: four fp32 or wgmma and one
                 GEMV), loss and grads against the plain version, ms an
                 iteration on the host's clock and on the card's.
 11. slice 8     bench.py's `_mha_latencies` leg tuned: `tune_flash`
                 sweeps heads_per_step 1, 2, 4, 8, 16 (64 x 64 tiles)
                 at (8, 16, 2048, 64) bf16 causal on the card and
                 records the winner in this run's cache; then the leg
                 as bench.py times it (the gradient of
                 flash_attention(causal=True) with no knob: a tuner hit
                 every call, the winner's launchers counted, its grads
                 held against hp=1) beside `attention_reference`'s.
                 Phase 5's GPT-350M step and phase 6's BERT-Large step
                 at attn_heads_per_step=2 (2 + 3 and 1 + 2 steps): every
                 flash launch a packed one (24 forwards and backwards a
                 step), no host sync, the loss falls, the first step's
                 loss bit for bit the hp=1 phase's; tokens/s, seq/s and
                 peak memory beside phases 5 and 6's; a 2-layer
                 kernels-vs-plain step of each.
 12. slice 14    phase 5's GPT-350M step with dropout 0.1, a fresh step
                 key each step through `loss_fn`, 2 + 3 steps: the loss
                 falls, every step runs 24 dropout flash forwards and
                 backwards (and no other flash launch), 49 LayerNorm
                 forwards and backwards and one Adam, no host sync;
                 tokens/s, peak memory, one profiled step with the
                 dropout kernels' device ms beside phase 5's, a 2-layer
                 kernels-vs-plain step on one key (the plain flash with
                 the kernels' mask).  The same with remat under None,
                 "dots" and "names:attn_ctx,ffn1", 1 + 2 steps each:
                 48 flash forwards and 97 LayerNorm forwards a step (the
                 recompute runs each block's forward again), peak
                 memory, device ms; one step's loss and gradients with
                 and without remat (full width, 2 layers), and whether
                 their bits agree.  bench.py's `_adam_1b_step_ms`
                 (`adam_flat` over 1e9 fp32 params, bf16 grads, 3 + 20
                 steps; ms a step beside its 26-bytes-a-param bound) and
                 `_gpt1p3b_tokens_per_sec` (GPT-1.3B, batch 7 x 512,
                 bf16, flash, FusedAdam master bf16, 3 + 20 steps;
                 tokens/s, peak memory, one profiled step).
 13. slice 16    the watchdog at full width: phase 3's engine and 64
                 requests under `EngineWatchdog(snapshot_every=1,
                 stall_timeout_s=2)`,
                 the `serve.stall_step` fail point fired at step 12;
                 `check()` raises `EngineStalledError` naming the step,
                 `restart()` resumes a fresh engine on the card, and
                 every request's tokens are phase 3's bit for bit;
                 stall-to-raise and restart seconds.  bench.py's
                 overload leg at full width: 256 requests against a
                 queue of 128 (shed-lowest-deadline, every odd one with
                 a 120 s deadline), drained; n_ok, n_shed, n_expired,
                 shed_fraction, goodput tokens/s and steps, gated on the
                 ledger's balance and a whole page pool.
 14. slice 17    the card as a torch.distributed NCCL group of one rank
                 (an in-process HashStore), the dp group checked as a
                 world of one.  (a) bench.py's ZeRO-2 bucket sweep at full
                 width: GPT (50304, h1024, 8 layers, 16 heads, seq 1024),
                 batch 8, bf16, flash, DistributedFusedAdam(num_shards=1,
                 lr=1e-4, master bf16) at n_buckets 1, 2 and 4 through
                 `ddp.make_train_step`, 2 + 10 steps each: tokens/s, peak
                 memory, no host sync, one Adam launch a bucket a step;
                 the params of n_buckets 2 and 4 bit for bit n_buckets
                 1's, and three steps bit for bit FusedAdam's through the
                 same step.  (b) phase 5's GPT-350M step as 4 microbatches
                 with fp32 main grads: the loss falls over 5 steps, no
                 host sync, tokens/s, peak memory, one profiled step.
                 (c) phase 6's BERT-Large step with
                 DistributedFusedLAMB(num_shards=1, no-decay wd_mask): no
                 host sync, seq/s; the optimizer alone bit for bit
                 FusedLAMB's over three steps of the same grads, clipped
                 and not; two steps against phase 6's FusedLAMB step
                 within three times FusedLAMB's own run-to-run.  (d)
                 phase 7's ResNet-50 step under amp O2 (bf16 weights,
                 fp32 batch norms, the fp32 master in FusedSGD's flat
                 buffer): as phase 7, with a two-step kernels-vs-plain
                 comparison whose second step is held to the drift of
                 the plain versions from a master nudged one ULP.
 15. slice 18    the card as a one-rank NCCL group again, the tp and dp
                 groups of `initialize_model_parallel(
                 tensor_model_parallel_size=1)` checked as one-rank NCCL
                 groups.  (a) bench.py's `_overlap_measure` cut from
                 tp = 2 to tp = 1 by the box: phase 5's GPT-350M (bf16,
                 bf16 logits, flash, FusedAdam(lr=1e-4, master bf16))
                 with sequence_parallel=True through
                 `make_tp_dp_train_step`, at overlap_chunks 1 and 2, 3 +
                 20 steps each: step ms, tokens/s, peak memory, the
                 device ms and the collectives of one profiled step (by
                 kind, held to the count the layers imply), phase 5's
                 launches, no host sync, the speedup; first-step losses
                 within 1e-3 relative, three steps' update within 3x two
                 monolithic runs' run-to-run.  (b) the same model without
                 sequence parallelism (the copy / reduce path), 1 + 3
                 steps: its collectives, no host sync, its first-step
                 loss within 1e-3 relative of phase 5's.
 16. slice 19    (a) the card as a one-rank NCCL group again, the pp,
                 tp and dp groups of `initialize_model_parallel(
                 pipeline_model_parallel_size=1)` checked as one-rank
                 NCCL groups: phase 5's GPT-350M as `GPTPipelined(pp=1)`,
                 the batch of 12 as 4 microbatches of 3, through
                 `make_tp_dp_train_step(pp_partial_grads=True)` at
                 checkpoint_window None and 1, 1 + 3 steps each: the
                 launches the clocked schedule implies (24 flash
                 forwards and backwards and 49 LayerNorm forwards and
                 backwards a microbatch, the window's recomputed
                 forwards again, Adam 1), no host sync, the all-reduces
                 of one profiled step held to the count the schedule
                 implies (no p2p call: a one-rank hop is a copy), step
                 ms, device ms, tokens/s, peak memory; the first-step
                 losses within 2e-3 of the plain `GPT.loss` on the same
                 weights and tokens and equal to each other.  (b) with no
                 process group, `host_pipeline_train_step` over GPT-350M
                 cut into 4 `HostPipelineStage`s of 6 blocks on the card
                 (the embedding on the first and last), 8 microbatches
                 of (1, 1024), "1f1b" and "gpipe", 1 + 3 steps each: the
                 launches a step, the mean loss within 2e-3 and each
                 stage's gradients (and the tied embedding's summed
                 ones) within 1e-2 relative L2 of one-program autograd
                 through the same stages, the in-flight peaks (1F1B's
                 bound; gpipe all 8), 1f1b's peak memory below gpipe's,
                 wall and device ms a step.
 17. slice 20    context parallelism.  (a) On the card as a one-rank
                 NCCL group, bench.py's 32k shape (1, 8, 32768, 64)
                 bf16 causal as grad(mean(o)), 1 + 5 iterations each,
                 through `flash_attention`, the contiguous ring, the
                 zigzag ring and Ulysses over the world group: the
                 contiguous ring at n = 1 is `flash_attention` bit for
                 bit (o, dq, dk, dv), zigzag and Ulysses within 1e-2 of
                 each tensor's largest magnitude; launches an iteration
                 (contiguous one forward, one dq pass and one dk/dv pass,
                 the two fp32; zigzag three of each; Ulysses
                 `flash_attention`'s); ms, tokens/s, peak memory beside
                 phase 9's leg.  (b) With no process group, the same
                 shape as 4 virtual ranks through `emulate_ring` (the
                 ring's step functions), contiguous and zigzag, causal,
                 rates 0 and 0.1: o and the gradients within 1e-2 of
                 single-device flash attention over the gathered
                 sequence with the same seed, each rank's launches as
                 the schedule implies (contiguous rank r: r + 1 chunks
                 on the split pair at 8192 keys; zigzag: 2n + 1
                 half-chunks a rank on the fused kernel at 4096; the
                 backward's fp32; skipped chunks launch nothing), and at
                 0.1 each kernel's mask read back at every chunk offset
                 pair the schedule ran.  (c) examples/
                 torch_long_context_training.py at its own defaults
                 (seq 32768, hidden 128, 2 heads, 2 layers, vocab 512)
                 on the one-rank group, 1 + 3 steps: the loss falls, the
                 launches a step, no host sync, one profiled step,
                 tokens/s, peak memory, the first-step loss within 2e-3
                 relative of the same model through the plain fp32
                 chunk versions on the card, and its first-step gradient
                 of every parameter within 1e-2 relative L2 of that
                 model's.
 18. slice 21    Mixture-of-Experts on the card as a one-rank NCCL group
                 (`build_moe_train_step` meshes over it: ep 1, the data
                 group the world).  (a) bench.py's `_moe_gpt_bench`: the
                 MoE-GPT step at the JAX bench's on-chip configuration
                 (vocab 50304, seq 1024, hidden 1024, 12 layers, 16
                 heads, 8 experts, top 2, capacity factor 1.25, bf16,
                 bf16 logits, flash), batch 8, ZeRO-2
                 DistributedFusedAdam(lr=1e-4, n_buckets=2, master bf16)
                 through `ddp.make_train_step`, 3 + 20 steps: the loss
                 finite and falling, every step 12 flash forwards and
                 fused backwards, 25 LayerNorm forwards and backwards and
                 two Adam launches, no host sync, the aux scalars
                 (drop fraction, aux loss, gate entropy, z loss) finite;
                 tokens/s, step ms, peak memory, one profiled step.  (b)
                 a 2-layer step of that model at batch 2 through the
                 kernels against the plain versions (one bucket),
                 phase 5's limits.  (c) the dense anchor: the model at
                 n_experts 1, top_k 1, capacity factor inf, no aux or z
                 loss, its experts a dense GPT's of the same width, 3
                 steps against that GPT's, within 3x the dense step's
                 own run-to-run (two runs in the call) in loss and
                 params, the router's weight unmoved.  (d) at the bench's
                 shapes the blocked router (1024 rows) bit for bit the
                 dense one, and the layer's forward and backward at
                 overlap_chunks 2 within 1e-2 of chunks 1's (bitwise
                 reported).
 19. slice 22    BERT at tp > 1 and the checkpoint package, on the card
                 as a one-rank NCCL group (the tp and dp groups of
                 `initialize_model_parallel(tensor_model_parallel_size=
                 1)`).  (a) phase 6's BERT-Large step (h1024, L24, 16
                 heads, seq 512, batch 32, bf16, flash with the padding
                 mask as segment ids, MLM + NSP, FusedLAMB(lr=1e-4, wd
                 0.01, master bf16, the no-decay mask)) through
                 `make_tp_dp_train_step` over those groups, 1 + 4 steps:
                 the launches a step phase 6's, no host sync, the loss
                 falls, the first loss within 1e-3 relative of phase
                 6's, the 2-layer kernels-vs-plain step within phase 6's
                 limits; seq/s, step and device ms, peak memory.  (b)
                 bench.py's `_ckpt_cycle` on the card: GPT at vocab
                 50304, seq 1024, h1024, L8, 16 heads, bf16, flash, batch
                 8, ZeRO-2 DistributedFusedAdam(lr=1e-4, n_buckets=2,
                 master bf16) through `ddp.make_train_step`; one step,
                 then CheckpointManager save, wait, restore: every state
                 field bit for bit; ckpt_blocking_s, ckpt_save_s,
                 ckpt_bytes, restore s, and the step's wall and device ms
                 with no write and with a write in flight on the writer
                 thread.  (c) the save → kill → resume gate on (b)'s
                 model: 8 steps with a commit at step 4 and a save at
                 step 6 killed by the `ckpt.mid_shards` fail point (that
                 step does not load, the latest committed step is 4), a
                 second unpreempted run, then a fresh optimizer and
                 manager restore step 4 (bit for bit the committed
                 state) and replay steps 5-8: the first replayed loss bit
                 for bit the baseline's, the later losses and the final
                 master flat within 3x the second run's distance from
                 the baseline; 8 flash forwards and backwards, 17
                 LayerNorm forwards and backwards and 2 Adam launches a
                 step; the committed state written by `save_sharded` as
                 a dp = 4 layout from four virtual shards restores at
                 dp = 1 bit for bit.  (d) bench.py's `_fleet_cycle` (n =
                 2^20, dp 4, two emulated hosts) through the port's
                 modules: the commit through the file barrier, a
                 half-fleet commit refused, one lost-rank resume that
                 re-shards to dp 2 and gives back the flat bit for bit;
                 barrier s.  The checkpoints live under a temporary
                 directory that the phase removes.
 20. slice 23    the monitored step: phase 5's GPT-350M (vocab 50304,
                 seq 1024, bf16, bf16 logits, flash, batch 12, seed-0
                 weights, FusedAdam(lr=1e-4, master bf16)) through
                 `ddp.make_train_step(metrics=, trace=)`.  (a) 5 steps
                 with metrics=True under a RecompileSentry and a
                 MetricsLogger (JSONL sink, memory watermarks, the
                 step's `gpt_step_flops`): every record passes
                 `validate_records`, the card resolves to an H100 row of
                 the peak table, mfu in (0, 1), hbm_peak_bytes_in_use
                 within 1 % of max_memory_allocated (the same allocator
                 stat), hbm_bytes_limit the card's total memory, the
                 bytes in use at least the live state's tensors and at
                 most the peak, the reserved bytes at most what the
                 driver has handed out, one signature.
                 (b) the metrics+trace step makes no host sync, its
                 first loss is the plain step's bit for bit, its master
                 params after 3 steps are within 2x the distance of two
                 plain runs from a plain run, and it launches phase 5's
                 kernels a step (flash 24 + 24, LayerNorm 49 + 49, Adam
                 1).  (c) 96 taps block0/ln1 ... block23/mlp in order,
                 both planes finite, the same with remat (no
                 CheckpointError).  (d) block 7's fc1 weight with one
                 inf under a dynamic loss scaler: the forward plane
                 names block7/mlp, the step is skipped (overflow and
                 skip counts +1, the master params bit for bit, the
                 scale halved), and a FlightRecorder.guard() around a
                 raise dumps a report that validates and renders naming
                 block7/mlp.  (e) the flagship engine built with
                 `recorder=` serves 8 requests; the recorder's dump
                 carries its serve plane and the sentry's compile event.
                 (f) the wall ms a step (5 synchronized steps) and one
                 profiled step's device ms, with neither plane, with the
                 metrics and with the metrics and the trace, beside the
                 card's name and power limit; each variant's launches
                 counted from before its warm-up to after its profiled
                 step.  (g) in a one-rank NCCL world, the step with
                 metrics, taps and `TraceConfig(rank_timing=True)` takes
                 its timing vector as a host list with no host sync and
                 returns it gathered on the card, and
                 `forward_backward_no_pipelining(rank_timing=)` gathers
                 a host list over the NCCL dp group.
 21. table       the kernels' times on the card (CUDA events) beside
                 their bounds, their plain versions and one library
                 call computing the same function; the softmax forward
                 also at the BERT step's own mask (no padding) and with
                 the bytes of x it reads; the fused dense GEMM's fp32
                 kernel at the MLP leg's four fp32 layers, its GEMV
                 kernel at the N = 1 layer (fp32 and bf16) and its
                 mma.sync kernel at one shape it still takes, each with
                 its plan, beside its bound and torch.addmm; the
                 LayerNorm forward at decode's, GPT-350M's, BERT-Large's
                 and GPT-1.3B's rows beside F.layer_norm, and its
                 backward at GPT's and BERT's rows beside F.layer_norm's
                 backward; the channel sums at each batch-norm shape of
                 the ResNet-50 step beside torch.var_mean (and their sum
                 a step); the launch floor: an empty kernel and a
                 one-block 16-byte copy (csrc/launch_floor.cu), built as
                 the port's kernels are; flash-decode with a cold and a
                 warm L2, by slot length (0, 1, 256) and at the long
                 case, beside SDPA; the flash kernels' dropout
                 instantiations at rate 0.1 beside their rate-0 times
                 and SDPA with dropout_p=0.1; the four segmented
                 optimizer kernels' shard times beside their whole
                 buffers', each kernel's launches in slice 17's, 19's,
                 20's, 21's, 22's and 23's legs (the backward rows' fp32
                 launches apart),
                 and the backward kernels with fp32 outputs at the
                 ring's chunk shapes beside their bf16 launches and
                 both bounds.

The tuner's cache is pinned to a fresh temporary file for the whole run,
so no cache elsewhere changes a phase's kernels: phase 5's step consults
it and must miss (0 hits, no packed launch), and each training phase's
line carries the tuner's hits, misses and fingerprint.

The line before the last is the kernel table as one JSON object; the
last line is {"ok": true, "device": {...}}.  Without CUDA, or without
the rest of the repository beside it, the script fails before printing
any result.
"""

import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
FP32_FLOPS = 67e12               # H100 SXM, fp32 outside the tensor cores
BF16_FLOPS = 989e12              # H100 SXM, dense bf16 tensor cores


class SmokeFailure(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


# ------------------------------------------------------------ timing ----

def time_ms(torch, fn, n=60, warm=5, flush=None):
    """Median device time of `fn` over n launches (CUDA events around
    each), after `warm` launches.  A long device sleep is queued first
    so the host enqueues every launch before the card reaches them: the
    events then bracket device work only, not host launch gaps.
    `flush` (optional) runs before each launch, outside the events."""
    for _ in range(warm):
        if flush is not None:
            flush()
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0)
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    torch.cuda._sleep(int(2e6 * min(2000.0, 3 * n * host_ms + 20)))
    for i in range(n):
        if flush is not None:
            flush()
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in zip(starts, ends))
    return times[n // 2]


# ----------------------------------------------------------- kernels ----

def flash_decode_case(torch, rng, *, n_slots, hkv, G, q_len, d, page,
                      max_pages, n_pages, lengths, dtype):
    dev = "cuda"
    q = torch.randn((n_slots, q_len, hkv * G, d), generator=rng,
                    device=dev).to(dtype)
    k = torch.randn((hkv, n_pages, page, d), generator=rng,
                    device=dev).to(dtype)
    v = torch.randn((hkv, n_pages, page, d), generator=rng,
                    device=dev).to(dtype)
    tbl = torch.randint(1, n_pages, (n_slots, max_pages), generator=rng,
                        device=dev, dtype=torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, k, v, tbl, lens


def decode_main_case(torch, rng):
    """The serving path's shape: 64 slots, 16 heads of 64, page 128, 2
    pages per slot, a 65-page pool; lengths ragged with 0, mid-page and
    page-aligned entries."""
    lengths = [0, 1, 5, 63, 127, 128, 129, 200, 255, 256, 0, 128]
    gl = torch.Generator().manual_seed(7)
    lengths += torch.randint(0, 257, (64 - len(lengths),),
                             generator=gl).tolist()
    return flash_decode_case(
        torch, rng, n_slots=64, hkv=16, G=1, q_len=1, d=64, page=128,
        max_pages=2, n_pages=65, lengths=lengths, dtype=torch.bfloat16)


def decode_long_case(torch, rng):
    """Few slots of long context, where the plan splits a slot's pages
    among a cluster's blocks: 4 slots x 16 heads of 64 at 4096 keys each
    (32 pages of 128), a 129-page pool."""
    return flash_decode_case(
        torch, rng, n_slots=4, hkv=16, G=1, q_len=1, d=64, page=128,
        max_pages=32, n_pages=129, lengths=[4096] * 4, dtype=torch.bfloat16)


def check_flash_decode(torch, fd, case, dtype, hp=None):
    """The kernel (heads_per_step `hp`, or the plan's) against
    `paged_attention_reference`, and a second run for the same bits.
    Returns the largest absolute error."""
    q, k, v, tbl, lens = case
    sc = 1.0 / math.sqrt(q.shape[3])
    out = fd.flash_decode_cuda(q, k, v, tbl, lens, sc, hp)
    again = fd.flash_decode_cuda(q, k, v, tbl, lens, sc, hp)
    ref = fd.paged_attention_reference(q, k, v, tbl, lens)
    torch.cuda.synchronize()
    check(torch.equal(out, again),
          f"flash_decode {fd.flash_decode_cuda.last_plan}: two runs differ")
    check(out.shape == ref.shape and out.dtype == ref.dtype,
          f"flash_decode shape/dtype {out.shape}/{out.dtype}")
    check(bool(torch.isfinite(out.float()).all()), "flash_decode non-finite")
    # rows with no visible position must be exact zeros
    q_len = q.shape[1]
    vis = (lens[:, None] - q_len + 1
           + torch.arange(q_len, device=q.device)[None, :])
    dead = out[vis <= 0]
    check(bool((dead == 0).all()), "flash_decode inactive rows not zero")
    err = (out.float() - ref.float()).abs()
    if dtype == torch.float32:
        tol = 1e-5 + 1e-5 * ref.float().abs()
    else:
        # p is rounded to bf16 before P.V, as on the TPU (kernel note)
        tol = torch.full_like(err, 2e-2)
    check(bool((err <= tol).all()),
          f"flash_decode {dtype} max err {err.max().item():.3e}")
    return err.max().item()


def check_layer_norm(torch, ln, rng, rows, hidden, dtype, rms=False,
                     weight=True, bias=True, row_stride=None):
    """The forward kernel against `norm_fwd_reference`, run twice for the
    same bits.  `row_stride` (elements) makes x a row-strided view of a
    wider buffer.  Tolerance: y one ulp of its dtype plus 1e-6 of the
    largest |y| (fp32: 1e-5 + 1e-5 |y|): where b cancels xhat * w the
    result is ~1e-7 and fp32 rounding of the operands (~3e-8) is many ulps
    of it; mean and rstd 1e-5 + 1e-5 of their value.  Returns the plan
    and the largest y error."""
    dev = "cuda"
    x = (torch.randn((rows, row_stride or hidden), generator=rng,
                     device=dev) * 2 + 0.5).to(dtype)[:, :hidden]
    w = (torch.randn((hidden,), generator=rng, device=dev) * 0.5
         + 1).to(dtype)
    b = (torch.randn((hidden,), generator=rng, device=dev) * 0.1).to(dtype)
    w = w if weight else None
    b = b if bias and not rms else None
    y, mean, rstd = ln.norm_fwd_cuda(x, w, b, 1e-5, rms)
    y2, mean2, rstd2 = ln.norm_fwd_cuda(x, w, b, 1e-5, rms)
    yr, meanr, rstdr = ln.norm_fwd_reference(x, w, b, 1e-5, rms)
    torch.cuda.synchronize()
    plan = ln.fwd_plan(rows, hidden, x.element_size(),
                       ln._sm_count(x.device), ln._align(x, y))
    what = (f"layer_norm ({rows},{hidden}) {dtype} rms={rms} weight="
            f"{weight} bias={bias} row_stride={row_stride} plan "
            f"{tuple(plan)}")
    check(y.dtype == dtype and y.shape == x.shape, f"{what}: shape/dtype")
    check(torch.equal(y, y2) and torch.equal(mean, mean2)
          and torch.equal(rstd, rstd2), f"{what}: two runs differ")
    err = (y.float() - yr.float()).abs()
    if dtype == torch.float32:
        tol = 1e-5 + 1e-5 * yr.abs()
    else:
        tol = ulp(torch, yr.float(), dtype) + 1e-6 * yr.float().abs().max()
    check(bool((err <= tol).all()),
          f"{what}: max err {err.max().item():.3e}")
    for a, r, name in ((mean, meanr, "mean"), (rstd, rstdr, "rstd")):
        check(bool(((a - r).abs() <= 1e-5 + 1e-5 * r.abs()).all()),
              f"{what}: {name}")
    return plan, err.max().item()


# the shapes the main paths give the LayerNorm forward: decode (64 slots),
# prefill-sized and ragged rows, GPT-350M's training rows (12 x 1024),
# BERT-Large's (32 x 512), GPT-1.3B's (7 x 512 rows of 2048)
LN_FWD_SHAPES = ((64, 1024), (128, 1024), (5, 1000), (12288, 1024),
                 (16384, 1024), (3584, 2048))
# ResNet-50's batch norms at batch 256, NHWC (the stride on the 3x3):
# (rows, C) -> how many of the 53 a step runs
RESNET50_BN_SHAPES = {
    (3_211_264, 64): 1, (802_816, 64): 6, (802_816, 256): 4,
    (802_816, 128): 1, (200_704, 128): 7, (200_704, 512): 5,
    (200_704, 256): 1, (50_176, 256): 11, (50_176, 1024): 7,
    (50_176, 512): 1, (12_544, 512): 5, (12_544, 2048): 4}


def launch_floor_times(torch):
    """`time_ms` of the two kernels of csrc/launch_floor.cu, built and
    bound as the port's kernels are: an empty kernel and a one-block
    16-byte copy (what a launch and one dependent load cost alone)."""
    import ctypes

    from apex_tpu_torch import csrc

    lib = csrc.load("launch_floor")
    vp = ctypes.c_void_p
    lib.apex_launch_floor_empty.argtypes = [vp]
    lib.apex_launch_floor_copy16.argtypes = [vp, vp, vp]
    src = torch.ones(4, dtype=torch.int32, device="cuda")
    dst = torch.zeros_like(src)

    def run(err):
        check(err == 0, f"launch floor kernel: CUDA error {err}")

    stream = (lambda: torch.cuda.current_stream().cuda_stream)
    out = {"empty_ms": time_ms(torch, lambda: run(
        lib.apex_launch_floor_empty(stream()))),
        "copy16_ms": time_ms(torch, lambda: run(
            lib.apex_launch_floor_copy16(src.data_ptr(), dst.data_ptr(),
                                         stream())))}
    torch.cuda.synchronize()
    check(torch.equal(src, dst), "launch floor: the 16-byte copy")
    return out


def layer_norm_fwd_checks(torch, ln, rng):
    """Phase 2's LayerNorm forward checks (`check_layer_norm`): every
    main-path shape (`LN_FWD_SHAPES`) in fp32 and bf16 with weight and
    bias, then RMSNorm, no weight, no bias, fp16, a row-strided view,
    4- and 2-byte rows, and the 12-warp rows past 8192 columns, ring and
    no ring.  Returns the largest bf16 error at decode's (64, 1024)."""
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    out = None
    for rows, hidden in LN_FWD_SHAPES:
        for dtype in (f32, bf16):
            plan, e = check_layer_norm(torch, ln, rng, rows, hidden, dtype)
            log(f"layer_norm ({rows},{hidden}) {dtype}: plan {tuple(plan)}, "
                f"max err {e:.3e}, two runs bit for bit")
            if (rows, hidden, dtype) == (64, 1024, bf16):
                out = e
    for rows, hidden, dtype, kw in (
            (64, 1024, bf16, {"rms": True}), (12288, 1024, bf16, {"rms": True}),
            (64, 1024, bf16, {"weight": False, "bias": False}),
            (12288, 1024, bf16, {"weight": False}),
            (3584, 2048, bf16, {"bias": False}), (64, 1024, f16, {}),
            (12288, 1024, f16, {}), (64, 1024, bf16, {"row_stride": 3072}),
            (12288, 1024, bf16, {"row_stride": 3072}),
            (12288, 1024, bf16, {"row_stride": 1026}),
            (77, 1001, f16, {}), (3000, 1001, f16, {}), (77, 1002, f16, {}),
            (33, 8192, f32, {}), (9, 16384, bf16, {}),
            (1000, 16384, bf16, {"rms": True}), (300, 12288, f32, {})):
        plan, e = check_layer_norm(torch, ln, rng, rows, hidden, dtype, **kw)
        log(f"layer_norm ({rows},{hidden}) {dtype} {kw}: plan "
            f"{tuple(plan)}, max err {e:.3e}, two runs bit for bit")
    return out


def channel_sums_checks(torch, wf, rng):
    """Phase 2's channel-sums checks (`check_channel_sums`): every
    distinct batch-norm shape of a ResNet-50 step at batch 256 in bf16
    (the O1 step's dtype), fp32 and fp16, and C = 3, a ragged C, fp64 and
    an x one element off 16 bytes (one element a load).  Returns the
    largest |kernel - plain| at the stem's shape in bf16."""
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    cases = [(r, c, dt, 0) for r, c in RESNET50_BN_SHAPES
             for dt in (bf16, f32, f16)]
    cases += [(802_816, 3, bf16, 0), (802_816, 3, f32, 0), (37, 16, f32, 0),
              (5000, 130, bf16, 0), (4096, 64, torch.float64, 0),
              (200_704, 128, bf16, 1)]
    out = None
    for rows, c, dtype, offset in cases:
        plan, e = check_channel_sums(torch, wf, rng, rows, c, dtype, offset)
        log(f"channel sums ({rows},{c}) {dtype} offset {offset}: plan "
            f"{tuple(plan)}, max |kernel - plain| {e:.3e}, two runs bit "
            f"for bit")
        if (rows, c, dtype) == (3_211_264, 64, bf16):
            out = e
        torch.cuda.empty_cache()
    return out


def ulp(torch, ref, dtype):
    """One ulp of `dtype` at |ref| (bf16: 8 significand bits, fp16: 11,
    fp32: 24)."""
    bits = {torch.bfloat16: 8, torch.float16: 11}.get(dtype, 24)
    return torch.ldexp(torch.ones_like(ref),
                       torch.frexp(ref.abs()).exponent - bits)


def pad_segments(torch, b, s, lengths):
    """BERT's segment ids for rows of `lengths` real tokens (cycled over
    the batch): 1 for real tokens, 0 for pads."""
    n = torch.tensor([lengths[i % len(lengths)] for i in range(b)],
                     device="cuda")
    return (torch.arange(s, device="cuda")[None, :] < n[:, None]).to(
        torch.int32)


def max_err(torch, what, got, ref, tol=1e-2):
    """max |got - ref|, checked against `tol` of ref's largest magnitude
    (the flash kernels' tolerance, `check_flash_attention`)."""
    check(got.shape == ref.shape, f"{what} shape {tuple(got.shape)} != "
          f"{tuple(ref.shape)}")
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    check(math.isfinite(err) and err <= tol * scale,
          f"{what}: max err {err:.3e} of max {scale:.3e}")
    return err


def check_flash_attention(torch, fa, rng, *, b, h, s, d, causal,
                          packed=False, q_seg=None, kv_seg=None):
    """Both flash kernels against the plain version (`attention_reference`
    and autograd through it) on one bf16 input.  packed=True lays q, k, v
    out as the training path does: strided views of one (S, B, 3H)
    tensor.  q_seg / kv_seg: segment ids, (b, s) int32.  Tolerance: 1e-2
    of each output's largest magnitude (the kernels round p and ds to
    bf16 before their products, as the TPU kernels do; the plain version
    keeps them fp32), and no NaN; lse 1e-4 on rows that see a key, and
    below -1e29 on rows whose keys are all masked.  The backward runs
    twice: dk and dv the same bits, each run's dq within the tolerance
    (dq's fp32 sums land in another order each run)."""
    dev, bf16 = "cuda", torch.bfloat16
    q, k, v, do = flash_inputs(torch, rng, b, h, s, d, packed)
    sc = 1.0 / math.sqrt(d)
    o, lse = fa.flash_fwd_cuda(q, k, v, sc, causal, q_seg, kv_seg)
    delta = torch.sum(do.float() * o.float(), dim=-1)
    dq, dk, dv = fa.flash_bwd_cuda(q, k, v, do, lse, delta, sc, causal,
                                   q_seg, kv_seg)
    dq2, dk2, dv2 = fa.flash_bwd_cuda(q, k, v, do, lse, delta, sc, causal,
                                      q_seg, kv_seg)
    qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))
    o_ref = fa.attention_reference(qr, kr, vr, causal=causal,
                                   softmax_scale=sc, q_segment_ids=q_seg,
                                   kv_segment_ids=kv_seg)
    o_ref.backward(do)
    with torch.no_grad():
        sco = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sc
        keep = torch.ones((1, 1, s, s), dtype=torch.bool, device=dev)
        if q_seg is not None:
            keep = keep & (q_seg[:, None, :, None] == kv_seg[:, None, None, :])
        if causal:
            keep = keep & torch.ones((s, s), dtype=torch.bool,
                                     device=dev).tril()
        sco = sco.masked_fill(~keep, -1e30)
        lse_ref = torch.logsumexp(sco, dim=-1)
        live = keep.any(dim=-1).expand_as(lse_ref)      # rows that see a key
        del sco, keep
    torch.cuda.synchronize()
    errs = {}
    for name, got, ref in (("o", o, o_ref), ("dq", dq, qr.grad),
                           ("dk", dk, kr.grad), ("dv", dv, vr.grad)):
        check(got.dtype == bf16, f"flash {name} dtype {got.dtype}")
        errs[name] = max_err(torch, f"flash {name} ({b},{h},{s},{d}) "
                             f"causal={causal}", got, ref)
    check(torch.equal(dk, dk2) and torch.equal(dv, dv2),
          f"flash ({b},{h},{s},{d}): dk, dv differ from run to run")
    errs["dq_second_run"] = max_err(torch, f"flash dq ({b},{h},{s},{d}) "
                                    f"second run", dq2, qr.grad)
    errs["dq_run_to_run"] = (dq.float() - dq2.float()).abs().max().item()
    errs["lse"] = (lse - lse_ref).abs()[live].max().item()
    check(errs["lse"] <= 1e-4, f"flash lse max err {errs['lse']:.3e}")
    check(bool((lse[~live] < -1e29).all()), "flash lse of a fully masked row")
    errs["dead_rows"] = int((~live).sum().item())
    return errs


def check_flash_cross(torch, fa, rng, *, b, h, sq, sk, d, causal, hp=2):
    """The flash pair where sq != sk and sk is not a multiple of the
    backward's 128-key tile: o, dq, dk, dv against the plain version
    (`attention_reference` and autograd, 1e-2 of each output's largest
    magnitude, as `check_flash_attention`), and dk, dv of the dk/dv pass
    and of the packed kernel at `hp` bit for bit the fused kernel's."""
    bf16 = torch.bfloat16
    q, do = (torch.randn((b, h, sq, d), generator=rng, device="cuda")
             .to(bf16) for _ in range(2))
    k, v = (torch.randn((b, h, sk, d), generator=rng, device="cuda")
            .to(bf16) for _ in range(2))
    sc = 1.0 / math.sqrt(d)
    o, lse = fa.flash_fwd_cuda(q, k, v, sc, causal)
    delta = torch.sum(do.float() * o.float(), dim=-1)
    args = (q, k, v, do, lse, delta, sc, causal)
    dq, dk, dv = fa.flash_bwd_cuda(*args)
    pdk, pdv = fa.flash_bwd_dkv_cuda(*args)
    _, kdk, kdv = fa.flash_bwd_packed_cuda(*args, hp)
    qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))
    o_ref = fa.attention_reference(qr, kr, vr, causal=causal,
                                   softmax_scale=sc)
    o_ref.backward(do)
    torch.cuda.synchronize()
    case = f"flash ({b},{h}) sq={sq} sk={sk} d={d} causal={causal}"
    check(torch.equal(pdk, dk) and torch.equal(pdv, dv),
          f"{case}: the dk/dv pass differs from the fused kernel")
    check(torch.equal(kdk, dk) and torch.equal(kdv, dv),
          f"{case}: the packed kernel (hp={hp}) differs from the fused one")
    return {name: max_err(torch, f"{case} {name}", got, ref)
            for name, got, ref in (("o", o, o_ref), ("dq", dq, qr.grad),
                                   ("dk", dk, kr.grad), ("dv", dv, vr.grad))}


def check_dq_pass(torch, fa, rng, *, b, h, sq, sk, d, causal, q_seg=None,
                  kv_seg=None):
    """The split backward's dq pass (`flash_bwd_dq_cuda`) against its plain
    version (`flash_bwd_dq_reference`) on one bf16 input and the forward
    kernel's lse, run twice: the two runs the same bits (each row is
    written once), each within 1e-2 of dq's largest magnitude (the
    tolerance of `check_flash_attention`: dS is rounded to bf16 before its
    product in both, its exponent taken in another order).  q_seg (b, sq)
    / kv_seg (b, sk): segment ids.  Returns the max error."""
    bf16 = torch.bfloat16
    q, do = (torch.randn((b, h, sq, d), generator=rng, device="cuda")
             .to(bf16) for _ in range(2))
    k, v = (torch.randn((b, h, sk, d), generator=rng, device="cuda")
            .to(bf16) for _ in range(2))
    sc = 1.0 / math.sqrt(d)
    o, lse = fa.flash_fwd_cuda(q, k, v, sc, causal, q_seg, kv_seg)
    delta = torch.sum(do.float() * o.float(), dim=-1)
    args = (q, k, v, do, lse, delta, sc, causal, q_seg, kv_seg)
    dq = fa.flash_bwd_dq_cuda(*args)
    dq_again = fa.flash_bwd_dq_cuda(*args)
    ref = fa.flash_bwd_dq_reference(*args)
    torch.cuda.synchronize()
    case = (f"dq pass ({b},{h}) sq={sq} sk={sk} d={d} causal={causal} "
            f"seg={q_seg is not None}")
    check(dq.dtype == bf16, f"{case}: dtype {dq.dtype}")
    check(torch.equal(dq, dq_again), f"{case}: two runs differ")
    return max_err(torch, case, dq, ref)


def bwd_ptxas(fa, log_text):
    """The backward kernels' lines of ptxas' report (csrc/build/
    flash_attention.log), the split dq pass's included: registers and
    spills by kernel, the dynamic shared memory each launch asks for, and
    ptxas' notes that it serialised wgmma instructions (C7512, C7515,
    C7520)."""
    rows, notes, name = {}, [], None
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else None
        elif name and any(k in name for k in (
                "flash_bwd_kernel", "flash_bwd_packed_kernel",
                "flash_bwd_dq_kernel")):
            if "Used " in line:
                rows.setdefault(name, {})["registers"] = int(
                    line.split("Used ")[1].split()[0])
            elif "spill" in line:
                rows.setdefault(name, {})["spills"] = line.strip()
        if "Performance Loss" in line and "flash_bwd_" in line:
            notes.append(line.strip()[:220])
    lib = fa._lib()
    smem = {f"d={d} seg={seg} dq={dq}": lib.apex_flash_attn_bwd_smem(
        d, seg, dq) for d in (64, 128) for seg in (0, 1) for dq in (0, 1)}
    smem.update({f"dq pass d={d} seg={seg}": lib.apex_flash_attn_bwd_dq_smem(
        d, seg) for d in (64, 128) for seg in (0, 1)})
    return rows, smem, notes


def flash_ptxas(log_text):
    """Every flash kernel's lines of ptxas' report: {mangled name:
    {"registers", "spills"}} and {mangled name: [serialised-wgmma note
    codes (C7512, C7515, C7518, C7520)]}."""
    rows, notes, name = {}, {}, None
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else None
        elif name and "Used " in line:
            rows.setdefault(name, {})["registers"] = int(
                line.split("Used ")[1].split()[0])
        elif name and "spill" in line:
            rows.setdefault(name, {})["spills"] = line.strip()
        if "Performance Loss" in line:
            code = re.search(r"\((C75\d\d)\)", line)
            fn = re.search(r"'(_Z[^']+)'", line)
            if code and fn:
                notes.setdefault(fn.group(1), []).append(code.group(1))
    return rows, notes


def dropout_twin(name):
    """The rate-0 twin of a DROP instantiation's mangled name (its last
    template argument, `Lb1E`, set to `Lb0E`), or None if `name` is not
    one."""
    m = re.match(r"(.*I(?:L[ib]\d+E)*)Lb1EE(.*)", name)
    if m is None or not any(k in name for k in (
            "flash_fwd_kernel", "flash_fwd_packed_kernel", "flash_bwd_kernel",
            "flash_bwd_packed_kernel", "flash_bwd_dq_kernel")):
        return None
    return f"{m.group(1)}Lb0EE{m.group(2)}"


def check_dropout_ptxas(log_text):
    """Phase 1's gate on the dropout instantiations: each has no spill and
    no serialised-wgmma note that its rate-0 twin lacks.  Returns their
    registers by kernel, beside the twin's."""
    rows, notes = flash_ptxas(log_text)
    out = {}
    for name, r in rows.items():
        twin = dropout_twin(name)
        if twin is None or twin not in rows:
            continue
        check(r.get("spills", "").startswith(
            "0 bytes stack frame, 0 bytes spill"),
            f"dropout instantiation {name} spills: {r}")
        new = set(notes.get(name, [])) - set(notes.get(twin, []))
        check(not new, f"dropout instantiation {name}: serialised-wgmma "
              f"notes {sorted(new)} that its rate-0 twin lacks")
        out[name] = (r.get("registers"), rows[twin].get("registers"))
    check(len(out) == 36, f"{len(out)} dropout instantiations, want 36")
    return out


def check_layer_norm_bwd(torch, ln, rng, rows, hidden, dtype, rms=False,
                         weight=True, offset=0):
    """The backward kernel against `norm_bwd_reference` on the forward
    kernel's mean/rstd, run twice for the same bits.  `offset` elements
    into a buffer places g off 16 bytes (the kernel's narrow loads).
    Tolerance: dx one ulp of its dtype plus 1e-5 of its largest
    magnitude (fp32 sums in another order before the one rounding); dw,
    db (fp32 sums over rows) 1e-5 of their largest.  Returns the kernel's
    plan and its largest dx error."""
    dev = "cuda"
    x = (torch.randn((rows, hidden), generator=rng, device=dev) * 2
         + 0.5).to(dtype)
    w = (torch.randn((hidden,), generator=rng, device=dev) * 0.5
         + 1).to(dtype)
    b = (None if rms else
         (torch.randn((hidden,), generator=rng, device=dev) * 0.1).to(dtype))
    gy = torch.randn((rows, hidden), generator=rng, device=dev).to(dtype)
    if offset:
        buf = torch.empty(rows * hidden + offset, dtype=dtype, device=dev)
        buf[offset:].copy_(gy.reshape(-1))
        gy = buf[offset:].view(rows, hidden)
    _, mean, rstd = ln.norm_fwd_cuda(x, w, b, 1e-5, rms)
    w = w if weight else None
    dx, dw, db = ln.norm_bwd_cuda(gy, x, mean, rstd, w, rms)
    dx2, dw2, db2 = ln.norm_bwd_cuda(gy, x, mean, rstd, w, rms)
    dxr, dwr, dbr = ln.norm_bwd_reference(gy, x, mean, rstd, w, rms)
    torch.cuda.synchronize()
    plan = ln.bwd_plan(rows, hidden, x.element_size(),
                       ln._sm_count(x.device), ln._align(gy, x, dx))
    what = (f"layer_norm bwd ({rows},{hidden}) {dtype} rms={rms} "
            f"weight={weight} plan {tuple(plan)}")
    check(torch.equal(dx, dx2) and (not weight or (
        torch.equal(dw, dw2) and torch.equal(db, db2))),
          f"{what}: two runs differ")
    check(dx.dtype == dtype, f"{what}: dx dtype {dx.dtype}")
    err = (dx.float() - dxr.float()).abs()
    tol = ulp(torch, dxr.float(), dtype) + 1e-5 * dxr.float().abs().max()
    check(bool((err <= tol).all()),
          f"{what}: dx max err {err.max().item():.3e}")
    if weight:
        check(dw.dtype == db.dtype == torch.float32, f"{what}: dw, db dtype")
        for name, got, ref in (("dw", dw, dwr), ("db", db, dbr)):
            e = (got - ref).abs().max().item()
            check(e <= 1e-5 * ref.abs().max().item(),
                  f"{what}: {name} max err {e:.3e}")
    else:
        check(dw is None and db is None, f"{what}: dw, db without weight")
    return plan, err.max().item()


def bert_large_layout(torch):
    """The BERT-Large flat layout as FusedLAMB lays it out (lane-aligned
    spec, FLAT_TILE-padded length) and the no-decay recipe's per-tensor
    weight decay, from the seed-0 model."""
    from apex_tpu_torch.models.bert import BertConfig, init_bert_params
    from apex_tpu_torch.ops import optimizer_kernels as ok
    from apex_tpu_torch.optimizers import flat as F
    from apex_tpu_torch.transformer.pipeline_parallel import (
        get_params_for_weight_decay_optimization)

    params = init_bert_params(BertConfig(dtype=torch.bfloat16,
                                         use_flash_attention=True))
    spec = F.make_spec(params, align=128)
    n = -(-spec.total // ok.FLAT_TILE) * ok.FLAT_TILE
    seg_wd, _ = F.resolve_per_leaf(
        get_params_for_weight_decay_optimization(params), None, 0.01,
        params, "chip_smoke")
    check((len(spec.sizes), sum(spec.sizes), n, int((seg_wd > 0).sum()))
          == (301, 336_201_730, 336_265_216, 102),
          "BERT-Large flat layout drifted")
    return spec, n, seg_wd


def check_lamb(torch, ok, rng, spec, n, seg_wd, dtype):
    """The four LAMB kernels against their plain versions on one
    BERT-Large flat buffer in `dtype` (zero padding, as FusedLAMB lays it
    out; bf16 grads): phase 1 with per-tensor wd, then a found_inf step
    (an inf grad: m and v kept bit for bit); phase 1 with one wd; the
    per-tensor sums of squares of p and u; phase 2 with the trust ratios
    of this p and u times per-tensor lr scales.  Tolerance: one ulp of
    `dtype` (the kernels evaluate the plain versions' operations one by
    one, without fma contraction); the sums rtol 1e-5.  Returns the
    largest errors by kernel."""
    dev = "cuda"
    real = torch.zeros(n, dtype=torch.bool, device=dev)
    for off, size in zip(spec.offsets, spec.sizes):
        real[off:off + size] = True

    def buf(scale, dt=dtype, absval=False):
        x = torch.randn((n,), generator=rng, device=dev) * scale
        return torch.where(real, x.abs() if absval else x, 0.0).to(dt)

    p, m, v = buf(0.05), buf(0.01), buf(1e-4, absval=True)
    g = buf(1.0, torch.bfloat16)
    del real
    seg = ok.segment_tables(spec, n // 128, dev)["seg"]
    wdt = ok._table(seg_wd, dev)
    errs = {}

    def close(name, got, ref):
        err = (got.float() - ref.float()).abs()
        check(bool((err <= ulp(torch, ref.float(), dtype)).all()),
              f"{name} {dtype}: max err {err.max().item():.3e}")
        errs[name] = max(errs.get(name, 0.0), err.max().item())

    for found in (False, True):
        gg = g.clone()
        if found:
            gg[12345] = float("inf")
        sc = ok._lamb_fold_scalars(0.8, 3, 0.9, 0.999, True, True, 1.0,
                                   found, device=dev)
        ref = ok._lamb_phase1_reference(m, v, gg, p, sc, 1e-6,
                                        wd_rows=wdt[seg.long()])
        got = ok.lamb_phase1_seg_triton(m.clone(), v.clone(), gg, p, sc,
                                        1e-6, seg, wdt)
        torch.cuda.synchronize()
        for a, r in zip(got, ref):
            close("lamb_phase1_seg", a, r)
        if found:
            check(torch.equal(got[0], m) and torch.equal(got[1], v),
                  "lamb phase 1: a found_inf step moved m or v")
        del gg, ref, got
    sc = ok._lamb_fold_scalars(1.0, 7, 0.9, 0.999, True, False, 0.5, False,
                               device=dev)
    ref = ok._lamb_phase1_reference(m, v, g, p, sc, 1e-6, weight_decay=0.01)
    got = ok.lamb_phase1_triton(m.clone(), v.clone(), g, p, sc, 1e-6, 0.01)
    torch.cuda.synchronize()
    for a, r in zip(got, ref):
        close("lamb_phase1", a, r)
    u = got[2]
    del ref, got, m, v, g
    sums = []
    for x in (p, u):
        got = ok.rows_sumsq_seg_triton(x, spec)
        ref = ok._rows_sumsq_reference(x, spec)
        torch.cuda.synchronize()
        rel = ((got - ref).abs() / ref.abs().clamp_min(1e-30)).max().item()
        check(rel <= 1e-5, f"rows_sumsq_seg {dtype}: max rel err {rel:.3e}")
        errs["rows_sumsq_seg"] = max(errs.get("rows_sumsq_seg", 0.0),
                                     (got - ref).abs().max().item())
        errs["rows_sumsq_seg_rel"] = max(
            errs.get("rows_sumsq_seg_rel", 0.0), rel)
        sums.append(got)
    wn, un = torch.sqrt(sums[0]), torch.sqrt(sums[1])
    scales = 0.5 + torch.rand(wn.shape, generator=rng, device=dev)
    ratio = torch.where((wn > 0) & (un > 0), wn / un.clamp_min(1e-12),
                        1.0) * scales
    rt = ok._table(ratio, dev)
    lr = torch.full((), 1e-2, device=dev)
    ref = ok._lamb_phase2_reference(p, u, rt[seg.long()], lr)
    got = ok.lamb_phase2_seg_triton(p.clone(), u, seg, rt, lr)
    torch.cuda.synchronize()
    close("lamb_phase2_seg", got, ref)
    check(bool((got[spec.total:] == 0).all()), "lamb phase 2 moved padding")
    return errs


def check_adam(torch, ok, rng, n, dtype, weight_decay):
    """The Adam kernel against `_adam_reference` on one step of seeded
    state (step 3, bf16 grads).  Tolerance: one ulp of the state dtype
    plus 1e-7 (the kernel may contract a multiply-add into one fma)."""
    dev = "cuda"
    p = torch.randn((n,), generator=rng, device=dev).to(dtype)
    m = (torch.randn((n,), generator=rng, device=dev) * 0.1).to(dtype)
    v = (torch.randn((n,), generator=rng, device=dev).abs()
         * 0.01).to(dtype)
    g = torch.randn((n,), generator=rng, device=dev).to(torch.bfloat16)
    sc = ok._adam_fold_scalars(1e-4, 3, 0.9, 0.999, True, 1.0, False,
                               device=dev)
    refs = ok._adam_reference(p, m, v, g, sc, 1e-8, weight_decay, True)
    got = ok.adam_flat_triton(p.clone(), m.clone(), v.clone(), g, sc, 1e-8,
                              weight_decay, True)
    torch.cuda.synchronize()
    worst = 0.0
    for name, a, r in zip("pmv", got, refs):
        err = (a.float() - r.float()).abs()
        check(bool((err <= ulp(torch, r.float(), dtype) + 1e-7).all()),
              f"adam {name} n={n} {dtype}: max err {err.max().item():.3e}")
        worst = max(worst, err.max().item())
    del refs, got
    return worst


def check_softmax(torch, sm, rng, shape, dtype, scale, *, causal=False,
                  mask=None, shift=0.0):
    """Both softmax kernels against their plain versions on one seeded
    input (scores 4·N(0, 1) + `shift`, N(0, 1) cotangents).  Tolerances: fp32 y
    within 2e-6 relative (the kernel's exp is the hardware `ex2.approx`,
    the plain version's `expf`; 1e-30 absolute for results that
    underflow); bf16 y within one bf16 ulp of the plain value.  dx:
    that, plus scale·|y|·1e-5·Σ|g·y| (Σ g·y is summed in fp32 in another
    order, and g - Σ cancels).  Returns the largest errors (fwd, bwd)
    and the number of rows whose every key is masked (they must come out
    uniform)."""
    dev = "cuda"
    x = (torch.randn(shape, generator=rng, device=dev) * 4 + shift).to(dtype)
    g = torch.randn(shape, generator=rng, device=dev).to(dtype)
    y = sm.softmax_fwd_triton(x, mask, scale, causal)
    yr = sm.softmax_fwd_reference(x, mask, scale, causal)
    torch.cuda.synchronize()
    check(y.dtype == dtype and y.shape == x.shape, "softmax shape/dtype")
    del x
    what = (f"softmax {tuple(shape)} {dtype} causal={causal} "
            f"mask={mask is not None}")

    def tol_of(ref):
        if dtype == torch.float32:
            return 2e-6 * ref.abs() + 1e-30
        return ulp(torch, ref, dtype)

    yr32 = yr.float()
    err = (y.float() - yr32).abs()
    check(bool((err <= tol_of(yr32)).all()),
          f"{what} fwd: max err {err.max().item():.3e}")
    fwd_err = err.max().item()
    dead = 0
    if mask is not None:
        full = mask.expand(shape).all(dim=-1)
        dead = int(full.sum().item())
        if dead:
            uni = y.float()[full]
            check(bool((uni == yr32[full]).all())
                  and bool((uni - 1.0 / shape[-1]).abs().max() <= 1e-7),
                  f"{what}: a fully masked row is not uniform")
        del full
    del err, yr, yr32
    dx = sm.softmax_bwd_triton(g, y, scale)
    dxr = sm.softmax_bwd_reference(g, y, scale)
    torch.cuda.synchronize()
    check(dx.dtype == dtype and dx.shape == g.shape, "softmax bwd shape")
    y32 = y.float()
    slack = (scale * y32.abs() * 1e-5
             * torch.sum((g.float() * y32).abs(), dim=-1, keepdim=True))
    dxr32 = dxr.float()
    err = (dx.float() - dxr32).abs()
    check(bool((err <= tol_of(dxr32) + slack).all()),
          f"{what} bwd: max err {err.max().item():.3e}")
    return fwd_err, err.max().item(), dead


def fwd_loads(torch, sm, shape, mask, causal):
    """The global loads, by instruction, in the PTX of the softmax forward
    compiled for bf16 scores of `shape` (`ld.global.v4.b32`: 16 bytes a
    thread), from an uncounted launch."""
    import re

    x = torch.zeros(shape, dtype=torch.bfloat16, device="cuda")
    _, kernel = sm._launch_fwd(x, mask, 0.125, causal)
    out = {}
    for ins in re.findall(r"ld\.global[\w.]*", kernel.asm["ptx"]):
        out[ins] = out.get(ins, 0) + 1
    return out


def dense_kernel_checks(torch, sm, rng):
    """Phase 2's softmax cases: GPT's causal (192, 1024, 1024) and BERT's
    (32, 16, 512, 512) with the ragged (32, 1, 1, 512) padding mask
    (512/300/129/0 real tokens: 8 sequences padded entirely, whose rows
    must come out uniform) in bf16; then fp32 at ragged widths (1, 7,
    1000, and 20000 and 9000 past the single-block cap), masks of
    (B, 1, S, S) and of leading dims that do not fold into three, and a
    small causal bf16.  Returns the errors at the main shapes."""
    f32, bf16 = torch.float32, torch.bfloat16
    sc = 0.125
    errs = {}
    fwd, bwd, _ = check_softmax(torch, sm, rng, (192, 1024, 1024), bf16, sc,
                                causal=True)
    errs["softmax_fwd"], errs["softmax_bwd"] = fwd, bwd
    loads = fwd_loads(torch, sm, (192, 1024, 1024), None, True)
    check("ld.global.v4.b32" in loads, f"softmax forward loads {loads}")
    log(f"softmax (192,1024,1024) causal bf16: max err fwd {fwd:.3e} "
        f"bwd {bwd:.3e}; forward loads {loads}")
    pad = pad_segments(torch, BERT_BATCH, BERT_SEQ, [512, 300, 129, 0]) == 0
    fwd, bwd, dead = check_softmax(torch, sm, rng,
                                   (BERT_BATCH, 16, BERT_SEQ, BERT_SEQ),
                                   bf16, sc, mask=pad[:, None, None, :])
    check(dead == 8 * 16 * BERT_SEQ, f"{dead} fully masked rows")
    errs["softmax_fwd_bert"], errs["softmax_bwd_bert"] = fwd, bwd
    loads = fwd_loads(torch, sm, (BERT_BATCH, 16, BERT_SEQ, BERT_SEQ),
                      pad[:, None, None, :], False)
    check("ld.global.v4.b32" in loads, f"softmax forward loads {loads}")
    log(f"softmax (32,16,512,512) padding mask bf16: max err fwd "
        f"{fwd:.3e} bwd {bwd:.3e}, {dead} uniform rows; forward loads "
        f"{loads}")
    g = torch.Generator(device="cuda").manual_seed(9)
    cases = [((3, 5, 1), None, False), ((4, 3, 7), None, False),
             ((2, 33, 1000), None, False), ((2, 3, 20000), None, False),
             ((1, 9000, 9000), None, True),
             ((2, 1, 3, 20000), (2, 1, 1, 20000), False),
             ((2, 3, 40, 40), (2, 1, 40, 40), False),
             ((2, 3, 4, 5, 7), (2, 1, 4, 1, 7), False)]
    for shape, mshape, causal in cases:
        mask = (None if mshape is None else
                torch.rand(mshape, generator=g, device="cuda") < 0.3)
        fwd, bwd, dead = check_softmax(torch, sm, rng, shape, f32, 0.3,
                                       causal=causal, mask=mask)
        log(f"softmax {shape} fp32 causal={causal} mask={mshape}: max err "
            f"fwd {fwd:.3e} bwd {bwd:.3e}, {dead} uniform rows")
    # scaled scores that sit near -10000 (scale 0.3, x = -10000 / 0.3 +
    # 4·N(0, 1): the other cases' spread), where the masked elements' term
    # of the sum matters: causal, BERT's padding (a fully padded sequence
    # among them) and a chunked row
    near = pad_segments(torch, 8, 512, [512, 300, 129, 0]) == 0
    for shape, mask, causal in (
            ((4, 8, 256, 256), None, True),
            ((8, 4, 512, 512), near[:, None, None, :], False),
            ((2, 1, 3, 20000),
             torch.rand((2, 1, 1, 20000), generator=g, device="cuda") < 0.3,
             False)):
        fwd, bwd, dead = check_softmax(torch, sm, rng, shape, f32, 0.3,
                                       causal=causal, mask=mask,
                                       shift=-10000.0 / 0.3)
        log(f"softmax {shape} fp32 near -10000 causal={causal} "
            f"mask={mask is not None}: max err fwd {fwd:.3e} bwd "
            f"{bwd:.3e}, {dead} uniform rows")
    fwd, bwd, _ = check_softmax(torch, sm, rng, (3, 77, 77), bf16, sc,
                                causal=True)
    log(f"softmax (3,77,77) causal bf16: max err fwd {fwd:.3e} "
        f"bwd {bwd:.3e}")
    return errs


def gpt350m_layout(torch):
    """The GPT-350M flat layout as FusedAdam lays it out with a wd_mask
    (lane-aligned spec, FLAT_TILE-padded length) and the no-decay
    recipe's per-tensor weight decay (Megatron's 0.01), from the seed-0
    model."""
    from apex_tpu_torch.models.gpt import GPTConfig, init_gpt_params
    from apex_tpu_torch.ops import optimizer_kernels as ok
    from apex_tpu_torch.optimizers import flat as F
    from apex_tpu_torch.transformer.pipeline_parallel import (
        get_params_for_weight_decay_optimization)

    params = init_gpt_params(GPTConfig(dtype=torch.bfloat16))
    spec = F.make_spec(params, align=128)
    n = -(-spec.total // ok.FLAT_TILE) * ok.FLAT_TILE
    seg_wd, _ = F.resolve_per_leaf(
        get_params_for_weight_decay_optimization(params), None, 0.01,
        params, "chip_smoke")
    check((len(spec.sizes), sum(spec.sizes), n, int((seg_wd > 0).sum()))
          == (292, 354_871_296, 354_877_440, 98),
          "GPT-350M flat layout drifted")
    return spec, n, seg_wd


def check_adam_seg(torch, ok, rng, spec, n, seg_wd, dtype):
    """The segmented Adam kernel against `_adam_seg_reference` on one
    GPT-350M flat buffer in `dtype` (zero padding, as FusedAdam lays it
    out; bf16 grads): AdamW with the no-decay wd and unit lr scales, L2
    mode with lr scales in [0.5, 1.5) per tensor, and a found_inf step
    (an inf grad: p, m and v kept bit for bit).  Every case bit for bit
    against the plain version, and the padding tail stays zero.  Returns
    the largest error (0.0 when every case is exact)."""
    dev = "cuda"
    real = torch.zeros(n, dtype=torch.bool, device=dev)
    for off, size in zip(spec.offsets, spec.sizes):
        real[off:off + size] = True

    def buf(scale, dt=dtype, absval=False):
        x = torch.randn((n,), generator=rng, device=dev) * scale
        return torch.where(real, x.abs() if absval else x, 0.0).to(dt)

    p, m, v = buf(0.05), buf(0.01), buf(1e-4, absval=True)
    g = buf(1.0, torch.bfloat16)
    del real
    seg = ok.segment_tables(spec, n // 128, dev)["seg"]
    rows = seg.long()
    wdt = ok._table(seg_wd, dev)
    ones = ok._table(torch.ones(len(spec.sizes), device=dev), dev)
    scales = ok._table(0.5 + torch.rand(len(spec.sizes), generator=rng,
                                        device=dev), dev)
    worst = 0.0
    for adam_w, lrt, found in ((True, ones, False), (False, scales, False),
                               (True, scales, True)):
        gg = g
        if found:
            gg = g.clone()
            gg[12345] = float("inf")
        sc = ok._adam_fold_scalars(1e-4, 3, 0.9, 0.999, True, 1.0, found,
                                   device=dev)
        ref = ok._adam_seg_reference(p, m, v, gg, sc, 1e-8, adam_w,
                                     wdt[rows], lrt[rows])
        got = ok.adam_flat_seg_triton(p.clone(), m.clone(), v.clone(), gg,
                                      sc, 1e-8, adam_w, seg, wdt, lrt)
        torch.cuda.synchronize()
        for name, a, r, before in zip("pmv", got, ref, (p, m, v)):
            worst = max(worst, (a.float() - r.float()).abs().max().item())
            check(torch.equal(a, r),
                  f"adam_flat_seg {name} {dtype} adam_w={adam_w} "
                  f"found={found}: not bit for bit the plain version")
            check(bool((a[spec.total:] == 0).all()),
                  f"adam_flat_seg moved the padding of {name}")
            if found:
                check(torch.equal(a, before),
                      f"adam_flat_seg: a found_inf step moved {name}")
        del ref, got, gg
    return worst


def check_adagrad(torch, ok, rng, n):
    """The Adagrad kernel against `_adagrad_reference` over the GPT-350M
    flat buffer (fp32 p and h, as FusedAdagrad keeps them), with bf16 and
    fp32 grads, L2 and decoupled weight decay, wd 0 and 0.01: bit for bit
    (the kernel evaluates the plain version's operations one by one).
    Returns the largest error (0.0 when every case is exact)."""
    dev = "cuda"
    p = torch.randn((n,), generator=rng, device=dev) * 0.05
    h = torch.randn((n,), generator=rng, device=dev).abs() * 1e-3
    lr = torch.full((), 1e-3, device=dev)
    worst = 0.0
    for gdt in (torch.bfloat16, torch.float32):
        g = (torch.randn((n,), generator=rng, device=dev) * 0.1).to(gdt)
        for w_mode in (False, True):
            for wd in (0.0, 0.01):
                ref = ok._adagrad_reference(p, h, g, lr, 1e-10, wd, w_mode)
                got = ok.adagrad_flat_triton(p.clone(), h.clone(), g, lr,
                                             1e-10, wd, w_mode)
                torch.cuda.synchronize()
                for name, a, r in zip("ph", got, ref):
                    worst = max(worst, (a - r).abs().max().item())
                    check(torch.equal(a, r),
                          f"adagrad {name} grads {gdt} w_mode={w_mode} "
                          f"wd={wd}: not bit for bit the plain version")
                del ref, got
        del g
    return worst


def check_lamb_phase2_flat(torch, ok, rng, spec, n, dtype):
    """`lamb_phase2_flat`'s kernel over the BERT-Large flat buffer in
    `dtype` with per-tensor trust ratios expanded per element by
    `expand_per_tensor_aligned`: bit for bit against its plain version
    and against `lamb_phase2_seg` fed the same per-tensor ratios.  u is
    zero past each tensor (as phase 1 leaves it); p carries values there,
    which both routes must leave untouched.  Returns the largest error
    (0.0 when exact)."""
    dev = "cuda"
    real = torch.zeros(n, dtype=torch.bool, device=dev)
    for off, size in zip(spec.offsets, spec.sizes):
        real[off:off + size] = True
    p = (torch.randn((n,), generator=rng, device=dev) * 0.05).to(dtype)
    u = torch.where(real, torch.randn((n,), generator=rng, device=dev)
                    * 0.01, 0.0).to(dtype)
    ratio = 0.5 + torch.rand(len(spec.sizes), generator=rng, device=dev)
    r = ok.expand_per_tensor_aligned(ratio, spec, n)
    lr = torch.full((), 1e-2, device=dev)
    ref = ok._lamb_phase2_flat_reference(p, u, r, lr)
    got = ok.lamb_phase2_flat_triton(p.clone(), u, r, lr)
    seg = ok.segment_tables(spec, n // 128, dev)["seg"]
    by_seg = ok.lamb_phase2_seg_triton(p.clone(), u, seg,
                                       ok._table(ratio, dev), lr)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    check(torch.equal(got, ref), f"lamb_phase2_flat {dtype}: not bit for "
          f"bit its plain version (max err {err:.3e})")
    check(torch.equal(got, by_seg), f"lamb_phase2_flat {dtype}: not bit "
          "for bit lamb_phase2_seg on the same ratios")
    check(torch.equal(got[~real], p[~real]),
          f"lamb_phase2_flat {dtype} moved the padding")
    check(not torch.equal(got[real], p[real]),
          f"lamb_phase2_flat {dtype} moved nothing")
    return err


def small_kernel_ptxas(lines):
    """{kernel (demangled enough to read): registers} and the spill lines
    that are not zero, from ptxas' report lines of one library."""
    regs, spills, name = {}, [], None
    for line in lines:
        if "Compiling entry" in line:
            name = line.split("'")[1] if "'" in line else line
            for key in ("ln_bwd_finish_kernel", "ln_bwd_kernel",
                        "ln_fwd_kernel", "decode_kernel",
                        "channel_sums_finish_kernel", "channel_sums_kernel"):
                if key in name:
                    tail = name.split(key, 1)[1]
                    end = tail.find("EEv")
                    name = key + (re.sub(r"L[ib](\d+)E?", r",\1",
                                         tail[:end]) if end > 0 else "")
                    break
        elif name and "Used " in line:
            regs[name] = int(line.split("Used ")[1].split()[0])
        elif name and "spill" in line and not line.startswith(
                "0 bytes stack frame, 0 bytes spill"):
            spills.append(f"{name}: {line}")
    return regs, spills


def fused_dense_ptxas(lines):
    """From ptxas' report on csrc/fused_dense.cu (its "Compiling entry",
    "Used" and spill lines): {family: [registers of each kernel]} with
    the families f32, gemv, mma, wgmma, and [(family, line)] for every
    kernel whose spill stores or loads are not 0 bytes."""
    fams, spills, fam = {}, [], None
    for ln_ in lines:
        if "Compiling entry" in ln_:
            fam = next((f for f in ("wgmma", "mma", "f32", "gemv")
                        if f"dense_{f}_kernel" in ln_), "other")
        elif "Used " in ln_ and fam:
            fams.setdefault(fam, []).append(
                int(ln_.split("Used ")[1].split()[0]))
        elif "spill" in ln_ and fam and not (
                "0 bytes spill stores" in ln_
                and "0 bytes spill loads" in ln_):
            spills.append((fam, ln_))
    return fams, spills


GEMM_ACTS = (None, "relu", "gelu", "sigmoid")
# (M, K, N): GPT-350M's MLP up and down projections over batch 12 x seq
# 1024; apex's tests/L0/run_mlp layers (batch 1024, mlp_sizes [480,
# 1024, 1024, 512, 256, 1]); ragged shapes; two shapes that TMA can
# address but that are ragged against the wgmma kernel's 128 x 256 x 64
# tile in M, N and K (its zero fill past each edge); an MoE router's
# N = 8 (8 experts over GPT-350M's hidden 1024, 4096 tokens)
GEMM_SHAPES = ((12288, 1024, 4096), (12288, 4096, 1024),
               (1024, 480, 1024), (1024, 1024, 1024), (1024, 1024, 512),
               (1024, 512, 256), (1024, 256, 1),
               (1000, 27, 13), (1000, 27, 1), (129, 70, 50), (1, 5, 3),
               (300, 200, 264), (12289, 1032, 520), (4096, 1024, 8))


def gemm_route_of(dtype, k, n):
    """The fused dense kernel a fresh (16-byte aligned) x (M, k) · w (k, n)
    in `dtype` must take, by the rule the port states (N <= 8 the GEMV
    kernel; TMA addresses rows whose stride is a multiple of 16 bytes),
    written out here on its own rather than read from `gemm_route`."""
    import torch
    if n <= 8:
        return "gemv"
    if dtype == torch.float32:
        return "fma"
    return "wgmma" if k > 0 and k % 8 == 0 and n % 8 == 0 else "mma"


def check_fused_dense(torch, fdn, rng, m, k, n, dtype):
    """The fused dense kernel against `linear_bias_reference` at x (m, k)
    · w (k, n) in `dtype`, for every activation with and without a bias:
    within 1e-2 of the largest magnitude of the plain result for 16-bit
    types (one rounding of the output, the products' fp32 sums in
    another order), 1e-5 for fp32.  x ~ N(0, 1), w ~ N(0, 1/k), b ~
    N(0, 1).  Each call must go through the route `gemm_route_of` names
    (by the route counters); the fp32 kernel at (1024, 512, 256) with K
    split among the blocks of a cluster, all its tiles' clusters in one
    wave of what the card holds (`f32_clusters`: an H100 SXM holds 15
    clusters of 8 128 x 128 blocks, so 16 tiles split 8 would take two),
    with 16-byte loads exactly where K and N are multiples of 4, the GEMV
    kernel where K fills whole 16-byte pieces; the fp32 and GEMV kernels
    run twice and give the same bits.  Returns (route, the largest error
    relative to that magnitude)."""
    dev = "cuda"
    route = gemm_route_of(dtype, k, n)
    x = torch.randn((m, k), generator=rng, device=dev).to(dtype)
    w = (torch.randn((k, n), generator=rng, device=dev)
         / math.sqrt(k)).to(dtype)
    b = torch.randn((n,), generator=rng, device=dev).to(dtype)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    worst = 0.0
    for act in GEMM_ACTS:
        for bias in (b, None):
            before = dict(fdn.linear_bias_cuda.route_launches)
            got = fdn.linear_bias_cuda(x, w, bias, act)
            moved = {r: fdn.linear_bias_cuda.route_launches[r] - before[r]
                     for r in before}
            check(moved == {r: int(r == route) for r in before},
                  f"fused dense ({m},{k})x({k},{n}) {dtype}: routes "
                  f"{moved}, want one {route} launch")
            plan = fdn.linear_bias_cuda.last_plan
            el = x.element_size()
            want_vec = {"fma": k % 4 == 0 and n % 4 == 0,
                        "gemv": k * el % 16 == 0}.get(route, False)
            if route == "fma" and (m, k, n) == (1024, 512, 256):
                split, tile = plan["split"], (128, plan["tile_n"])
                held = fdn.f32_clusters(x.device)[tile][split - 1]
                tiles = -(-m // tile[0]) * -(-n // tile[1])
                check(split > 1 and tiles <= held,
                      f"fused dense ({m},{k})x({k},{n}): plan {plan}, "
                      f"want K split in one wave of clusters")
            check(plan["vec"] == want_vec,
                  f"fused dense ({m},{k})x({k},{n}) {dtype}: plan {plan}")
            if route in ("fma", "gemv"):
                again = fdn.linear_bias_cuda(x, w, bias, act)
                torch.cuda.synchronize()
                check(torch.equal(got, again),
                      f"fused dense {route} ({m},{k})x({k},{n}): two runs "
                      f"differ")
                del again
            ref = fdn.linear_bias_reference(x, w, bias, act)
            torch.cuda.synchronize()
            check(got.dtype == dtype and got.shape == (m, n),
                  "fused dense output dtype or shape")
            scale = ref.float().abs().max().item()
            err = (got.float() - ref.float()).abs().max().item()
            check(math.isfinite(err) and err <= tol * scale,
                  f"fused dense ({m},{k})x({k},{n}) {dtype} act={act} "
                  f"bias={bias is not None}: max err {err:.3e} of "
                  f"{scale:.3e}")
            worst = max(worst, err / max(scale, 1e-30))
            del got, ref
    return route, worst


def check_xent(torch, xe, rng, rows, v, smoothing, dtype):
    """Both cross-entropy kernels against their plain versions on one
    seeded input (logits 3·N(0, 1), uniform labels, N(0, 1) cotangents).
    Tolerance: loss and lse 1e-5 of |lse| (the kernel's exp is the
    hardware's ex2.approx, ~2e-6 relative, and it sums in another
    order); dx one ulp of its dtype plus 1e-5 of its largest magnitude.
    Returns the largest errors (forward, backward)."""
    dev = "cuda"
    x = (torch.randn((rows, v), generator=rng, device=dev) * 3).to(dtype)
    y = torch.randint(0, v, (rows,), generator=rng, device=dev,
                      dtype=torch.int32)
    g = torch.randn((rows,), generator=rng, device=dev)
    loss, lse = xe.xent_fwd_triton(x, y, smoothing)
    rloss, rlse = xe.xent_fwd_reference(x, y, smoothing)
    dx = xe.xent_bwd_triton(g, x, y, rlse, smoothing)
    rdx = xe.xent_bwd_reference(g, x, y, rlse, smoothing)
    torch.cuda.synchronize()
    tol = 1e-5 * rlse.abs() + 1e-6
    e_fwd = torch.maximum((loss - rloss).abs(), (lse - rlse).abs())
    check(loss.dtype == lse.dtype == torch.float32 and dx.dtype == dtype,
          "xentropy dtypes")
    check(bool((e_fwd <= tol).all()),
          f"xentropy fwd ({rows},{v}) eps={smoothing} {dtype}: max err "
          f"{e_fwd.max().item():.3e}")
    e_dx = (dx.float() - rdx.float()).abs()
    tol_dx = ulp(torch, rdx.float(), dtype) + 1e-5 * rdx.float().abs().max()
    check(bool((e_dx <= tol_dx).all()),
          f"xentropy bwd ({rows},{v}) eps={smoothing} {dtype}: max err "
          f"{e_dx.max().item():.3e}")
    return e_fwd.max().item(), e_dx.max().item()


RESNET50_FLAT = 25_559_040          # 25,557,032 params, FLAT_TILE-padded


def check_sgd(torch, ok, rng, n):
    """The SGD kernel against `_sgd_reference` over the ResNet-50 flat
    buffer (fp32 p and buf, bf16 grads, a loss scale of 2^16): the step's
    flags at a steady and at the first step, nesterov, dampening, weight
    decay after momentum, and a found_inf step (an inf grad: p and buf
    kept bit for bit).  Tolerance: one fp32 ulp (the kernel evaluates the
    plain version's operations one by one, without fma contraction).
    Returns the largest error and whether every case was bit for bit."""
    dev = "cuda"
    p = torch.randn((n,), generator=rng, device=dev) * 0.05
    b = torch.randn((n,), generator=rng, device=dev) * 0.01
    g = (torch.randn((n,), generator=rng, device=dev) * 65536).to(
        torch.bfloat16)
    worst, exact = 0.0, True
    # (momentum, dampening, nesterov, weight_decay, wd_after, first)
    for flags in ((0.9, 0.0, False, 1e-4, False, False),
                  (0.9, 0.0, False, 1e-4, False, True),
                  (0.9, 0.0, True, 1e-4, False, False),
                  (0.9, 0.1, False, 0.0, False, False),
                  (0.9, 0.0, False, 1e-2, True, False),
                  (0.0, 0.0, False, 1e-4, False, False)):
        sc = ok._sgd_scalars(0.1, 2.0 ** -16, False, flags[5], device=dev)
        args = flags[:5] + (False,)
        rp, rb = ok._sgd_reference(p, b, g, sc, *args)
        kp, kb = ok.sgd_flat_triton(p.clone(), b.clone(), g, sc, *args)
        torch.cuda.synchronize()
        for name, a, r in (("p", kp, rp), ("buf", kb, rb)):
            err = (a - r).abs()
            check(bool((err <= ulp(torch, r, torch.float32)).all()),
                  f"sgd {name} {flags}: max err {err.max().item():.3e}")
            worst = max(worst, err.max().item())
            exact = exact and torch.equal(a, r)
        del rp, rb, kp, kb
    gi = g.clone()
    gi[4321] = float("inf")
    sc = ok._sgd_scalars(0.1, 2.0 ** -16, True, False, device=dev)
    kp, kb = ok.sgd_flat_triton(p.clone(), b.clone(), gi, sc, 0.9, 0.0,
                                False, 1e-4, False, False)
    torch.cuda.synchronize()
    check(torch.equal(kp, p) and torch.equal(kb, b),
          "sgd: a found_inf step moved p or buf")
    del p, b, g, gi, kp, kb
    return worst, exact


def check_channel_sums(torch, wf, rng, rows, c, dtype, offset=0):
    """The per-channel sums kernel against fp64 sums of the same values,
    and against its plain version, run twice for the same bits.  `offset`
    elements into a buffer places x off 16 bytes (one element a load).
    Tolerance: Σx within 1e-5 of Σ|x| and Σx² within 1e-5 of itself, per
    channel (fp32 partial sums over runs of rows; the plain version is
    held to the same bound).  Returns the kernel's plan and its largest
    absolute difference from the plain version."""
    x = (torch.randn((rows * c + offset,), generator=rng, device="cuda")
         + 0.5).to(dtype)[offset:].view(rows, c)
    s, q = wf.channel_sums_cuda(x)
    s2, q2 = wf.channel_sums_cuda(x)
    rs, rq = wf.channel_sums_reference(x)
    align = 16 if x.data_ptr() % 16 == 0 else x.element_size()
    plan = wf.sums_plan(rows, c, x.element_size(), wf._sm_count(x.device),
                        align)
    x64 = x.double()
    s64, q64, a64 = x64.sum(0), (x64 * x64).sum(0), x64.abs().sum(0)
    del x64
    torch.cuda.synchronize()
    what = f"channel sums ({rows},{c}) {dtype} plan {tuple(plan)}"
    check(torch.equal(s, s2) and torch.equal(q, q2),
          f"{what}: two runs differ")
    for name, got, want, scale in (("sum", s, s64, a64), ("sumsq", q, q64,
                                                           q64),
                                   ("plain sum", rs, s64, a64),
                                   ("plain sumsq", rq, q64, q64)):
        rel = ((got.double() - want).abs() / scale).max().item()
        check(rel <= 1e-5, f"{what} {name}: {rel:.3e} of the scale")
    return plan, max((s - rs).abs().max().item(),
                     (q - rq).abs().max().item())


def profile_decode(torch, np, build_flagship_engine, params, steps=4):
    """Where a full-width decode step's time goes: 64 live slots (prompts
    of 1..96 tokens, so every request fits one page and all 64 are
    admitted at once), `steps` pure decode steps under torch.profiler.
    Returns the wall time per step, the device-busy share (kernel time
    summed over the window's wall time; one stream, so kernels do not
    overlap) and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    eng = build_flagship_engine(params=params)
    rng = np.random.RandomState(2)
    for _ in range(eng.serve_cfg.n_slots):
        eng.submit(rng.randint(0, eng.model_cfg.vocab_size,
                               int(rng.randint(1, 97))).tolist(), 32)
    for _ in range(3):                       # admit all, then warm up
        eng.step()
    g = eng.gauges()
    check(g["queue_depth"] == 0 and g["slots_live"] == eng.serve_cfg.n_slots,
          "profile: not every slot is live")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            check(eng.step() == (0, 0), "profile: a step churned")
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = {}                  # device-side events only: CPU ops
    for e in prof.key_averages():  # carry their kernels' time as well
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.key] = (kernels.get(e.key, 0.0)
                              + e.self_device_time_total)
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    decode = sum(t for k, t in kernels.items() if "decode_kernel" in k)
    norm = sum(t for k, t in kernels.items() if "ln_fwd_kernel" in k)
    return {"steps": steps, "wall_ms_per_step": wall_us / steps / 1e3,
            "device_ms_per_step": busy / steps / 1e3,
            "flash_decode_ms_per_step": decode / steps / 1e3,
            "layer_norm_fwd_ms_per_step": norm / steps / 1e3,
            "device_busy_share": busy / wall_us,
            "top_kernels_ms_per_step": {k[:80]: v / steps / 1e3
                                        for k, v in top}}


def training_kernels(fa, ln, ok):
    from apex_tpu_torch.ops import softmax as sm

    return {"flash_attention_fwd": fa.flash_fwd_cuda,
            "flash_attention_bwd": fa.flash_bwd_cuda,
            "flash_attention_bwd_dq": fa.flash_bwd_dq_cuda,
            "flash_attention_bwd_dkv": fa.flash_bwd_dkv_cuda,
            "flash_attention_fwd_packed": fa.flash_fwd_packed_cuda,
            "flash_attention_bwd_packed": fa.flash_bwd_packed_cuda,
            "elementwise": ok.elementwise_triton,
            "layer_norm_fwd": ln.norm_fwd_cuda,
            "layer_norm_bwd": ln.norm_bwd_cuda,
            "softmax_fwd": sm.softmax_fwd_triton,
            "softmax_bwd": sm.softmax_bwd_triton,
            "adam": ok.adam_flat_triton,
            "adam_seg": ok.adam_flat_seg_triton,
            "lamb_phase1": ok.lamb_phase1_triton,
            "lamb_phase1_seg": ok.lamb_phase1_seg_triton,
            "rows_sumsq_seg": ok.rows_sumsq_seg_triton,
            "lamb_phase2_seg": ok.lamb_phase2_seg_triton,
            "lamb_phase2_flat": ok.lamb_phase2_flat_triton,
            "adagrad": ok.adagrad_flat_triton}


# the flash launchers' counts of their dropout launches (the DROP
# instantiations), by row name
DROPOUT_KERNELS = {
    "flash_attention_fwd_dropout": "flash_fwd_cuda",
    "flash_attention_bwd_dropout": "flash_bwd_cuda",
    "flash_attention_fwd_packed_dropout": "flash_fwd_packed_cuda",
    "flash_attention_bwd_packed_dropout": "flash_bwd_packed_cuda",
    "flash_attention_bwd_dq_dropout": "flash_bwd_dq_cuda",
    "flash_attention_bwd_dkv_dropout": "flash_bwd_dkv_cuda"}


# the flash backward launchers' counts of their fp32-output launches (the
# F32 instantiations, the ring's chunk backward), by row name
F32_KERNELS = {
    "flash_attention_bwd_f32": "flash_bwd_cuda",
    "flash_attention_bwd_dq_f32": "flash_bwd_dq_cuda",
    "flash_attention_bwd_dkv_f32": "flash_bwd_dkv_cuda"}


def kernel_counts(fa, ln, ok):
    counts = {name: fn.launches
              for name, fn in training_kernels(fa, ln, ok).items()}
    counts.update({name: getattr(fa, fn).dropout_launches
                   for name, fn in DROPOUT_KERNELS.items()})
    counts.update({name: getattr(fa, fn).f32_launches
                   for name, fn in F32_KERNELS.items()})
    return counts


def reset_kernel_counts(fa, ln, ok):
    for fn in training_kernels(fa, ln, ok).values():
        fn.launches = 0
    for fn in DROPOUT_KERNELS.values():
        getattr(fa, fn).dropout_launches = 0
    for fn in F32_KERNELS.values():
        getattr(fa, fn).f32_launches = 0


def tune_stats(reset=False):
    """The tuner's hits, misses and fingerprint (the cache this run pinned
    at its start); `reset` zeroes the counts first."""
    from apex_tpu_torch import tune

    if reset:
        tune.reset_stats()
    return tune.stats()


def device_time_by_kernel(torch, prof):
    """Device time (us) summed by kernel name from a torch.profiler run
    (device-side events only: CPU ops carry their kernels' time too)."""
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.key] = kernels.get(e.key, 0.0) + e.self_device_time_total
    return kernels


def step_without_sync(torch, step, state, *args):
    """One training step in which no call may synchronize the host with
    the card (torch's sync debug mode warns on each one it detects).
    Returns the new state and the places that synchronized (none, or
    the phase fails)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            state, _ = step(state, *args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
             if "synchronizing CUDA operation" in str(w.message)]
    check(not syncs, f"the training step synchronized with the card at "
          f"{syncs}")
    return state, syncs


def profile_step(torch, step, state, args, names):
    """One training step under torch.profiler: wall and device time, the
    busy share, the GEMMs, the ATen glue, the port's kernels (`names`
    maps a row name to a match on the profiler's kernel names), the top
    kernels and ATen ops.  Returns the new state and that line."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        state, _ = step(state, *args)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t1)
    kernels = device_time_by_kernel(torch, prof)
    busy = sum(kernels.values())
    check(busy > 0, "the profiled training step shows no device time")
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    ours = {name: sum(t for k, t in kernels.items() if match(k)) / 1e3
            for name, match in names.items()}

    def is_gemm(k):
        return any(w in k.lower() for w in ("gemm", "nvjet", "xmma",
                                            "cutlass"))

    gemm = sum(t for k, t in kernels.items() if is_gemm(k)) / 1e3
    aten = sum(t for k, t in kernels.items()
               if "at::native" in k and not is_gemm(k)) / 1e3
    # the ATen ops whose own kernels take the most device time
    ops = sorted(((e.key, e.self_device_time_total)
                  for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CPU
                  and e.key.startswith("aten::")
                  and e.self_device_time_total > 0), key=lambda kv: -kv[1])
    return state, {
        "wall_ms": wall_us / 1e3, "device_ms": busy / 1e3,
        "device_busy_share": busy / wall_us,
        "gemm_ms": gemm, "aten_elementwise_reduce_copy_ms": aten,
        "kernels_ms": ours,
        "other_ms": busy / 1e3 - gemm - aten - sum(ours.values()),
        "top_kernels_ms": {k[:90]: v / 1e3 for k, v in top},
        "top_aten_ops_ms": {k: v / 1e3 for k, v in ops[:15]}}


def train_loop(torch, fa, ln, ok, what, step, state, args, per_step,
               warmup, steps):
    """`warmup` then `steps` timed calls of `state, loss = step(state,
    *args)` from zeroed launch counts: the losses finite and falling, the
    launch counts `per_step` each step.  Returns the state and the
    measurements (window seconds, losses, counts, peak memory)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts(fa, ln, ok)
    tune_stats(reset=True)
    losses = []
    t0 = time.perf_counter()
    for _ in range(warmup):
        state, loss = step(state, *args)
        losses.append(loss)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(steps):
        state, loss = step(state, *args)
        losses.append(loss)
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    counts = kernel_counts(fa, ln, ok)
    losses = [float(x) for x in losses]
    log(f"{what} losses {losses}")
    check(all(math.isfinite(x) for x in losses), f"a {what} loss is not "
          "finite")
    check(losses[-1] < losses[0], f"{what} loss did not fall: {losses}")
    total = warmup + steps
    for name, n in per_step.items():
        check(counts[name] == n * total,
              f"{what} {name}: {counts[name]} launches in {total} steps, "
              f"want {n} per step")
    return state, {"warmup_steps": warmup, "steps": steps, "losses": losses,
                   "tune": tune_stats(),
                   "warmup_s": warm_s, "window_s": window_s,
                   "step_ms": 1e3 * window_s / steps,
                   "peak_mem_gib": torch.cuda.max_memory_allocated()
                   / 2 ** 30, "launches": counts,
                   "launches_per_step": per_step}


def keyed_loss(torch, model, seed=None):
    """`model.loss` with a dropout key: a fresh CPU generator each call
    (seeds 0, 1, 2, ...), or with `seed` the same one every call."""
    import itertools

    seeds = itertools.count()

    def loss_fn(p, t, lab):
        key = torch.Generator().manual_seed(
            next(seeds) if seed is None else seed)
        return model.loss(p, t, lab, key=key)

    return loss_fn


def gpt_train_phase(torch, fa, ln, ok, what, flash, make_opt, opt_desc,
                    opt_swaps, per_step, names, warmup, steps, batch=12,
                    seq=1024, lr=1e-4, model_kw=None, compare=True):
    """The GPT-350M training step at full width (module docstring,
    phases 5, 8 and 9): `gpt_350m` in bf16, batch x seq (12 x 1024
    unless asked), bf16 logits, seed-0 weights, `flash` attention or the
    dense path, the optimizer of `make_opt(params)` (`opt_desc` says
    which); `warmup` steps, then `steps` timed ones on one seeded batch.
    Checks the losses and the launch counts (`per_step` each step),
    takes a step with no host sync and a profiled one (`names`: the
    kernels to sum), and compares a 2-layer step through the kernels
    with the plain step (`opt_swaps`: the optimizer's plain stand-ins)
    at two of the batch's sequences (one when the batch has one); `lr`
    is the optimizer's, which bounds how far one step moves a weight;
    `model_kw`: more `GPTConfig` fields (with a `dropout`, each step gets
    a fresh key through `loss_fn`, and the comparison one fixed key).
    Returns the measurements and that comparison."""
    from apex_tpu_torch.models import gpt as gpt_mod
    from apex_tpu_torch.transformer.training import (
        init_sharded_optimizer, make_tp_dp_train_step)

    bf16 = torch.bfloat16
    model = gpt_mod.gpt_350m(**{
        "vocab_size": 50304, "seq_len": seq, "dropout": 0.0, "dtype": bf16,
        "logits_dtype": bf16, "use_flash_attention": flash,
        **(model_kw or {})})
    cfg = model.c
    params = model.init(seed=0)
    opt = make_opt(params)
    state = init_sharded_optimizer(opt, model, params)
    del params
    n_params = sum(opt.spec.sizes)
    keyed = cfg.dropout > 0
    step = make_tp_dp_train_step(
        model, opt, loss_fn=keyed_loss(torch, model) if keyed else None)
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                           device="cuda", dtype=torch.int32)
    labels = torch.roll(tokens, -1, dims=1)
    state, result = train_loop(torch, fa, ln, ok, what, step, state,
                               (tokens, labels), per_step, warmup, steps)
    check(int(state.step) == warmup + steps,
          f"optimizer step {int(state.step)}")
    state, syncs = step_without_sync(torch, step, state, tokens, labels)
    state, profile_line = profile_step(torch, step, state, (tokens, labels),
                                       names)
    del state, opt, step
    torch.cuda.empty_cache()
    result = dict(
        result, config=f"GPT-350M bf16, batch {batch} x seq {seq}, bf16 "
        f"logits, {'flash' if flash else 'dense'} attention"
        f"{''.join(f', {k}={v}' for k, v in (model_kw or {}).items())}, "
        f"{opt_desc}",
        params=n_params,
        tokens_per_s=batch * seq * steps / result["window_s"],
        host_syncs_per_step=len(syncs), profile=profile_line)
    if not compare:
        return result, None
    return result, compare_train_step(torch, fa, ln, ok, gpt_mod, cfg, what,
                                      make_opt, opt_swaps, tokens[:2],
                                      labels[:2], lr=lr, keyed=keyed)


def plain_adam(ok):
    """`adam_flat_triton`'s plain stand-in (in place, as the kernel
    updates), for the kernels-vs-plain steps."""
    def adam(p, m, v, g, scalars, eps, weight_decay, adam_w_mode):
        for buf, new in zip((p, m, v), ok._adam_reference(
                p, m, v, g, scalars, eps, weight_decay, adam_w_mode)):
            buf.copy_(new)
        return p, m, v
    return adam


def zero_step_fn(step, last=None):
    """`ddp.make_train_step`'s step (no loss scaler) as `train_loop`
    drives it: (state, batch) -> (state, loss); with `last`, the aux
    (has_aux) kept in last["aux"]."""
    def fn(state, b):
        out = step(state, None, b)
        if last is not None:
            last["aux"] = out[3]
        return out[0], out[2]
    return fn


def flash_gpt_phase(torch, fa, ln, ok, what, backward, warmup, steps,
                    batch=12, seq=1024, heads_per_step=None, dropout=0.0,
                    remat_policy=False, compare=True):
    """The flash GPT-350M step with FusedAdam(lr=1e-4, master bf16) at
    batch x seq (phases 5, 9, 11 and 12).  `backward` is the route every
    layer's backward must take, "fused" (seq 1024), "split" (seq 8192)
    or "packed" (`heads_per_step` > 1, phase 11, whose forward is the
    packed one too): 24 launches a step of each of its kernels and none
    of the others'.  `dropout` > 0 (phase 12): each step a fresh key,
    every flash launch a dropout one; `remat_policy` (not False: None,
    "dots" or "names:..."): remat, whose recompute runs each block's
    forward again (48 flash forwards and 97 LayerNorm forwards a step);
    `compare`: the kernels-vs-plain 2-layer step."""
    from apex_tpu_torch.optimizers import FusedAdam

    split, packed = backward == "split", backward == "packed"
    check(packed == (heads_per_step is not None),
          "the packed route needs heads_per_step")
    per_step = {"flash_attention_fwd": 0 if packed else 24,
                "flash_attention_fwd_packed": 24 if packed else 0,
                "flash_attention_bwd": 24 if backward == "fused" else 0,
                "flash_attention_bwd_packed": 24 if packed else 0,
                "flash_attention_bwd_dq": 24 if split else 0,
                "flash_attention_bwd_dkv": 24 if split else 0,
                "layer_norm_fwd": 49, "layer_norm_bwd": 49, "adam": 1}
    names = {"flash_attention_fwd": lambda k: "flash_fwd_kernel" in k,
             "flash_attention_fwd_packed":
                 lambda k: "flash_fwd_packed_kernel" in k,
             "layer_norm_fwd": lambda k: "ln_fwd_kernel" in k,
             "layer_norm_bwd": lambda k: "ln_bwd_" in k,
             "adam": lambda k: k == "_adam_kernel"}
    if split:      # the dk/dv pass is flash_bwd_kernel<D, SEG, false>
        names.update(
            flash_attention_bwd_dq=lambda k: "flash_bwd_dq_kernel" in k,
            flash_attention_bwd_dkv=lambda k: "flash_bwd_kernel" in k)
    elif packed:
        names["flash_attention_bwd_packed"] = (
            lambda k: "flash_bwd_packed_kernel" in k)
    else:
        names["flash_attention_bwd"] = lambda k: "flash_bwd_kernel" in k
    model_kw = {}
    if heads_per_step is not None:
        model_kw["attn_heads_per_step"] = heads_per_step
    if dropout:
        check(backward == "fused", "phase 12 drives the fused route")
        model_kw["dropout"] = dropout
        per_step.update(flash_attention_fwd_dropout=24,
                        flash_attention_bwd_dropout=24)
        # the DROP instantiations' device time beside the whole kernels'
        names.update(
            flash_attention_fwd_dropout=lambda k: (
                "flash_fwd_kernel<64, false, true>" in k),
            flash_attention_bwd_dropout=lambda k: (
                "flash_bwd_kernel<64, false, true, true>" in k))
    if remat_policy is not False:
        model_kw.update(remat=True, remat_policy=remat_policy)
        per_step.update(flash_attention_fwd=48, layer_norm_fwd=97)
        if dropout:
            per_step["flash_attention_fwd_dropout"] = 48
    return gpt_train_phase(
        torch, fa, ln, ok, what, True,
        lambda params: FusedAdam(lr=1e-4, master_dtype=torch.bfloat16),
        "FusedAdam(lr=1e-4, master bf16)",
        [(ok, "adam_flat_triton", plain_adam(ok))], per_step, names,
        warmup=warmup, steps=steps, batch=batch, seq=seq,
        model_kw=model_kw or None, compare=compare)


def train_phase(torch, fa, ln, ok):
    """Phase 5: the flash step on the fused backward, one warm-up step
    and four timed ones (five in all, as before).  The tuner is consulted
    (every knob None) and, with this run's empty cache, misses: no hit
    and no packed launch."""
    train, vs_plain = flash_gpt_phase(torch, fa, ln, ok, "train", "fused",
                                      warmup=1, steps=4)
    check(train["tune"]["hits"] == 0 and train["tune"]["misses"] > 0,
          f"phase 5's step took a tuned config: {train['tune']}")
    return train, vs_plain


def kernels_vs_plain_step(torch, fa, ln, ok, what, model, make_opt,
                          loss_fn, swaps, tokens, labels, lr=1e-4):
    """One training step through the kernels and one through their plain
    versions (`swaps`: (module, name, plain stand-in) set for the plain
    run), from the same weights (`model.init(seed=0)`) and a fresh
    optimizer each (`make_opt(params)`).  Compares the loss, each leaf's
    gradient (relative L2 error) and the updated flat params, with the
    limits of the flash step's comparison (phase 5).  A ZeRO optimizer
    (one bucket) steps through `ddp.make_train_step`, the others through
    `make_tp_dp_train_step`."""
    from apex_tpu_torch.parallel import ddp
    from apex_tpu_torch.transformer.training import (
        init_sharded_optimizer, make_tp_dp_train_step)

    params = model.init(seed=0)

    def run(plain):
        opt = make_opt(params)
        seen = {}
        step_flat = opt.step_flat

        def capture(st, g_flat, **kw):
            # a ZeRO optimizer takes its list of buckets (here one)
            g = g_flat[0] if isinstance(g_flat, list) else g_flat
            seen.setdefault("g", g.clone())
            return step_flat(st, g_flat, **kw)

        opt.step_flat = capture
        if hasattr(opt, "full_leaves"):
            state = opt.init(params)
            loss_of = loss_fn or model.loss
            zstep = ddp.make_train_step(lambda p, b: loss_of(p, *b), opt)

            def step(st, t, lab):
                st, _, loss = zstep(st, None, (t, lab))
                return st, loss
        else:
            state = init_sharded_optimizer(opt, model, params)
            step = make_tp_dp_train_step(model, opt, loss_fn=loss_fn)
        saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
        if plain:
            for mod, name, fn in swaps:
                setattr(mod, name, fn)
        try:
            state, loss = step(state, tokens, labels)
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)
        flat = (state.params_shard if hasattr(opt, "full_leaves")
                else state.params)
        return float(loss), seen["g"], flat, opt.spec

    before = kernel_counts(fa, ln, ok)
    loss_p, g_p, p_p, spec = run(plain=True)
    check(kernel_counts(fa, ln, ok) == before,
          f"the plain {what} step launched a kernel")
    loss_k, g_k, p_k, _ = run(plain=False)
    torch.cuda.synchronize()
    grad_rel = {}
    for path, off, size in zip(spec.paths, spec.offsets, spec.sizes):
        a = g_k[off:off + size].float()
        r = g_p[off:off + size].float()
        name = "/".join(path)
        if r.norm().item() > 0:
            grad_rel[name] = ((a - r).norm() / r.norm()).item()
        else:       # BERT's unused token types: zero through both paths
            check(a.norm().item() == 0, f"{what} step grads: {name} is 0 "
                  "through the plain versions but not through the kernels")
    worst = max(grad_rel, key=grad_rel.get)
    dp = (p_k.float() - p_p.float()).abs()
    line = {"loss_kernels": loss_k, "loss_plain": loss_p,
            "loss_rel_diff": abs(loss_k - loss_p) / abs(loss_p),
            "grad_rel_l2_max": grad_rel[worst], "grad_rel_l2_worst": worst,
            "grad_rel_l2_median": sorted(grad_rel.values())[
                len(grad_rel) // 2],
            "param_max_abs_diff": dp.max().item(),
            "param_frac_differ": (dp > 0).float().mean().item()}
    log(f"{what} step, kernels vs plain versions " + json.dumps(line))
    # as for the flash step (phase 5): bf16 roundings in other places move
    # the loss by ~1e-5 and each gradient by < 1 %; one step moves a
    # weight by about lr, so the two updated buffers may differ by 2 lr
    # plus one bf16 ulp
    check(line["loss_rel_diff"] <= 1e-3, f"{what} step loss: kernels vs plain")
    check(line["grad_rel_l2_max"] <= 3e-2,
          f"{what} step grads: kernels vs plain ({worst})")
    check(line["param_max_abs_diff"] <= 2 * lr + 2 ** -9,
          f"{what} step params: kernels vs plain")
    return line


def attention_swaps(mod, fa, cfg):
    """The plain stand-ins of a model's attention kernels, for
    `kernels_vs_plain_step`: the flash pair (in `mod`, the model's
    module) or the softmax pair, as `cfg.use_flash_attention` says."""
    from apex_tpu_torch.ops import softmax as sm

    if not cfg.use_flash_attention:
        return [(sm, "softmax_fwd_triton", sm.softmax_fwd_reference),
                (sm, "softmax_bwd_triton", sm.softmax_bwd_reference)]

    def plain_flash(q, k, v, *, softmax_scale, causal=False,
                    segment_ids=None, block_q=None, block_k=None,
                    heads_per_step=None, dropout_rate=0.0, dropout_key=None):
        if dropout_rate > 0.0:
            # the kernels' mask: the same host draw from the key
            seed = fa._seed3(fa._common.host_seed(dropout_key))
            return fa.flash_fwd_reference(
                q, k, v, softmax_scale, causal, segment_ids, segment_ids,
                dropout_rate=dropout_rate, seed=seed)[0]
        return fa.attention_reference(q, k, v, causal=causal,
                                      softmax_scale=softmax_scale,
                                      q_segment_ids=segment_ids,
                                      kv_segment_ids=segment_ids)

    return [(mod, "flash_attention", plain_flash)]


def compare_train_step(torch, fa, ln, ok, gpt_mod, cfg, what, make_opt,
                       opt_swaps, tokens, labels, lr=1e-4, keyed=False):
    """One full-width GPT step of a 2-layer model at the batch of `tokens`
    through the kernels and through their plain versions
    (`kernels_vs_plain_step`):
    the attention kernels of `cfg`, the LayerNorm, and the optimizer's
    (`opt_swaps`); `keyed`: both steps with one fixed dropout key, so the
    same masks."""
    import dataclasses

    model = gpt_mod.GPT(dataclasses.replace(cfg, num_layers=2))
    return kernels_vs_plain_step(
        torch, fa, ln, ok, what, model, make_opt,
        keyed_loss(torch, model, seed=7) if keyed else None,
        attention_swaps(gpt_mod, fa, cfg)
        + [(gpt_mod, "fused_layer_norm", ln.layer_norm_reference)]
        + opt_swaps, tokens, labels, lr=lr)


BERT_BATCH, BERT_SEQ = 32, 512


def bert_data(torch, cfg, batch):
    """The bench's BERT batch (`bench.py:319-324`), each part from its own
    seeded generator: random tokens, MLM labels = tokens rolled by -1, a
    Bernoulli(0.15) loss mask, random NSP labels."""
    def gen(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    tokens = torch.randint(0, cfg.vocab_size, (batch, cfg.seq_len),
                           generator=gen(1), device="cuda",
                           dtype=torch.int32)
    mlm = torch.roll(tokens, -1, dims=1)
    mask = torch.rand((batch, cfg.seq_len), generator=gen(2),
                      device="cuda") < 0.15
    nsp = torch.randint(0, 2, (batch,), generator=gen(3), device="cuda",
                        dtype=torch.int32)
    return tokens, (mlm, mask, nsp)


def bert_phase(torch, fa, ln, ok, flash=True, steps=5, heads_per_step=None):
    """The BERT-Large pretraining step at full width with `flash` or the
    dense attention (module docstring, phases 6, 8 and 11): one step
    that builds the kernels, then `steps` - 1 timed ones on the bench's
    seeded batch.  Checks the losses and the launch counts each step,
    takes a step with no host sync and a profiled one.  With flash and
    no `heads_per_step` (phase 6), then two steps of the same model with
    FusedLAMB without a wd_mask (the optimizer's unmasked path); with
    `heads_per_step` (phase 11) every flash launch is a packed one.
    Returns the measurements and the kernel-vs-plain comparison."""
    from apex_tpu_torch.models import bert as bert_mod
    from apex_tpu_torch.optimizers import FusedLAMB
    from apex_tpu_torch.transformer.pipeline_parallel import (
        get_params_for_weight_decay_optimization)
    from apex_tpu_torch.transformer.training import (
        init_sharded_optimizer, make_tp_dp_train_step)

    bf16 = torch.bfloat16
    what = "bert" if flash else "dense BERT"
    if heads_per_step is not None:
        what = f"bert hp={heads_per_step}"
    cfg = bert_mod.BertConfig(seq_len=BERT_SEQ, dtype=bf16,
                              use_flash_attention=flash,
                              attn_heads_per_step=heads_per_step)
    check((cfg.vocab_size, cfg.hidden, cfg.num_layers, cfg.num_heads,
           cfg.logits_dtype) == (30528, 1024, 24, 16, None),
          "BERT-Large configuration drifted")
    model = bert_mod.Bert(cfg)

    def loss_fn(p, t, lab):
        return model.loss(p, t, lab[0], lab[1], lab[2])

    params = model.init(seed=0)
    opt = FusedLAMB(lr=1e-4, weight_decay=0.01, master_dtype=bf16,
                    wd_mask=get_params_for_weight_decay_optimization(params))
    state = init_sharded_optimizer(opt, model, params)
    del params
    n_params = sum(opt.spec.sizes)
    step = make_tp_dp_train_step(model, opt, loss_fn=loss_fn)
    tokens, labels = bert_data(torch, cfg, BERT_BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts(fa, ln, ok)
    tune_stats(reset=True)
    losses = []
    t_first = time.perf_counter()
    state, loss = step(state, tokens, labels)     # builds the LAMB kernels
    losses.append(loss)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t_first
    t0 = time.perf_counter()
    for _ in range(steps - 1):
        state, loss = step(state, tokens, labels)
        losses.append(loss)
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    counts = kernel_counts(fa, ln, ok)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    log(f"{what} losses {losses}")
    check(all(math.isfinite(x) for x in losses), f"a {what} loss is not "
          "finite")
    check(losses[-1] < losses[0], f"{what} loss did not fall: {losses}")
    check(int(state.step) == steps, f"LAMB step {int(state.step)}")
    n_flash, n_softmax = (cfg.num_layers, 0) if flash else (0,
                                                            cfg.num_layers)
    n_packed = n_flash if heads_per_step is not None else 0
    per_step = {"flash_attention_fwd": n_flash - n_packed,
                "flash_attention_bwd": n_flash - n_packed,
                "flash_attention_fwd_packed": n_packed,
                "flash_attention_bwd_packed": n_packed,
                "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
                "softmax_fwd": n_softmax, "softmax_bwd": n_softmax,
                "layer_norm_fwd": 2 * cfg.num_layers + 2,
                "layer_norm_bwd": 2 * cfg.num_layers + 2,
                "adam": 0, "adam_seg": 0, "lamb_phase1": 0,
                "lamb_phase1_seg": 1, "rows_sumsq_seg": 2,
                "lamb_phase2_seg": 1}
    for name, k in per_step.items():
        check(counts[name] == k * steps,
              f"{what} {name}: {counts[name]} launches in {steps} steps, "
              f"want {k} per step")
    state, syncs = step_without_sync(torch, step, state, tokens, labels)
    attention = ({"flash_attention_fwd": lambda k: "flash_fwd_kernel" in k,
                  "flash_attention_bwd": lambda k: "flash_bwd_kernel" in k,
                  "flash_attention_fwd_packed":
                      lambda k: "flash_fwd_packed_kernel" in k,
                  "flash_attention_bwd_packed":
                      lambda k: "flash_bwd_packed_kernel" in k}
                 if flash else
                 {"softmax_fwd": lambda k: k == "_softmax_fwd_kernel",
                  "softmax_bwd": lambda k: k == "_softmax_bwd_kernel"})
    names = dict(attention,
                 layer_norm_fwd=lambda k: "ln_fwd_kernel" in k,
                 layer_norm_bwd=lambda k: "ln_bwd_" in k,
                 lamb_phase1_seg=lambda k: k == "_lamb_phase1_kernel",
                 rows_sumsq_seg=lambda k: k in ("_sumsq_items_kernel",
                                                "_sumsq_segments_kernel"),
                 lamb_phase2_seg=lambda k: k == "_lamb_phase2_seg_kernel")
    state, profile_line = profile_step(torch, step, state, (tokens, labels),
                                       names)
    del state, opt, step
    tuned = tune_stats()
    packing = ("" if heads_per_step is None
               else f", attn_heads_per_step={heads_per_step}")
    result = {
        "config": f"BERT-Large bf16 (V 30528, H 1024, L 24, 16 heads), "
                  f"batch 32 x seq 512, "
                  f"{'flash' if flash else 'dense'} attention{packing}"
                  f", fp32 MLM "
                  f"logits, MLM + NSP, FusedLAMB(lr=1e-4, wd 0.01, master "
                  f"bf16, no-decay wd_mask)",
        "params": n_params, "steps": steps, "losses": losses,
        "tune": tuned, "first_step_s": first_s,
        "step_ms": 1e3 * window_s / (steps - 1),
        "seq_per_s": BERT_BATCH * (steps - 1) / window_s,
        "tokens_per_s": BERT_BATCH * BERT_SEQ * (steps - 1) / window_s,
        "peak_mem_gib": peak / 2 ** 30, "host_syncs_per_step": len(syncs),
        "launches": counts, "launches_per_step": per_step,
        "profile": profile_line}

    if flash and heads_per_step is None:   # the unmasked optimizer path
        opt = FusedLAMB(lr=1e-4, weight_decay=0.01, master_dtype=bf16)
        state = init_sharded_optimizer(opt, model, model.init(seed=0))
        step = make_tp_dp_train_step(model, opt, loss_fn=loss_fn)
        reset_kernel_counts(fa, ln, ok)
        for _ in range(2):
            state, loss = step(state, tokens, labels)
        torch.cuda.synchronize()
        unmasked = kernel_counts(fa, ln, ok)
        check(unmasked["lamb_phase1"] == 2
              and unmasked["lamb_phase1_seg"] == 0
              and unmasked["rows_sumsq_seg"] == 4
              and unmasked["lamb_phase2_seg"] == 2,
              f"unmasked FusedLAMB launches {unmasked}")
        check(math.isfinite(float(loss)), "unmasked LAMB loss is not finite")
        result["unmasked_lamb_launches_2_steps"] = unmasked
        del state, opt, step, loss
    torch.cuda.empty_cache()
    return result, compare_bert_step(torch, fa, ln, ok, bert_mod, cfg, what,
                                     tokens[:2], tuple(t[:2] for t in labels))


def compare_bert_step(torch, fa, ln, ok, bert_mod, cfg, what, tokens,
                      labels):
    """One full-width BERT step of a 2-layer model at batch 2 with a
    ragged padding mask (512 and 300 real tokens) and FusedLAMB with the
    no-decay mask, through the kernels and through their plain versions
    (`kernels_vs_plain_step`): the attention kernels of `cfg`, the
    LayerNorm and the LAMB kernels."""
    import dataclasses

    from apex_tpu_torch.optimizers import FusedLAMB
    from apex_tpu_torch.transformer.pipeline_parallel import (
        get_params_for_weight_decay_optimization)

    model = bert_mod.Bert(dataclasses.replace(cfg, num_layers=2))
    pad = pad_segments(torch, 2, cfg.seq_len, [cfg.seq_len, 300]) == 0

    def loss_fn(p, t, lab):
        return model.loss(p, t, lab[0], lab[1], lab[2], pad_mask=pad)

    def make_lamb(params):
        return FusedLAMB(lr=1e-4, weight_decay=0.01, master_dtype=cfg.dtype,
                         wd_mask=get_params_for_weight_decay_optimization(
                             params))

    def plain_phase1_seg(m, v, g, p, scalars, eps, seg, wdt):
        mn, vn, u = ok._lamb_phase1_reference(m, v, g, p, scalars, eps,
                                              wd_rows=wdt[seg.long()])
        m.copy_(mn)
        v.copy_(vn)
        return m, v, u

    def plain_phase2_seg(p, u, seg, rt, lr):
        return p.copy_(ok._lamb_phase2_reference(p, u, rt[seg.long()], lr))

    return kernels_vs_plain_step(
        torch, fa, ln, ok, what, model, make_lamb, loss_fn,
        attention_swaps(bert_mod, fa, cfg)
        + [(bert_mod, "fused_layer_norm", ln.layer_norm_reference),
           (ok, "lamb_phase1_seg_triton", plain_phase1_seg),
           (ok, "rows_sumsq_seg_triton", ok._rows_sumsq_reference),
           (ok, "lamb_phase2_seg_triton", plain_phase2_seg)],
        tokens, labels)


RESNET_BATCH, RESNET_SIZE = 256, 224


def resnet_kernels(xe, wf, ok):
    return {"xent_fwd": xe.xent_fwd_triton, "xent_bwd": xe.xent_bwd_triton,
            "sgd": ok.sgd_flat_triton, "channel_sums": wf.channel_sums_cuda,
            "rows_sumsq_seg": ok.rows_sumsq_seg_triton}


def resnet_counts(xe, wf, ok):
    return {name: fn.launches
            for name, fn in resnet_kernels(xe, wf, ok).items()}


def resnet_setup(torch, batch, seed=0, larc=False, opt_level="O1"):
    """The bench's ResNet-50 AMP-O1 step (`bench.py:338-391`, its on-chip
    branch) on the card: seed-`seed` weights, amp O1 (bf16 compute, fp32
    params, dynamic loss scale from 2^16), the mean of the fp32 cross
    entropy, FusedSGD(0.1, 0.9, 1e-4) over the fp32 flat buffer (inside
    LARC(trust_coefficient=0.02, clip=True) with `larc`) and
    `make_train_step(with_state=True)`; a batch of `batch` 224x224x3
    N(0, 1) images and uniform labels over 1000 classes, each from its
    own seeded generator.  `opt_level="O2"` (slice 17, apex's
    `main_amp.py --opt-level O2`): `amp.initialize(params, "O2")` makes
    the convolution and fc weights bf16 and keeps the batch norms' fp32,
    FusedSGD's fp32 flat buffer is the master, and the step reads the
    bf16 weights and fp32 batch-norm params (the loss function records
    their dtypes in `step.param_dtypes` on its first call).  Returns
    (opt, step, carry, (x, y))."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.models import resnet as rn
    from apex_tpu_torch.ops.xentropy import softmax_cross_entropy_loss
    from apex_tpu_torch.optimizers import FusedSGD
    from apex_tpu_torch.optimizers import flat as F
    from apex_tpu_torch.parallel import ddp

    model = rn.resnet50()
    params, mstate = model.init(seed=seed)
    if opt_level == "O2":
        params, amp_state = amp.initialize(params, opt_level="O2")
    else:
        amp_state = amp.initialize(opt_level="O1")
    param_dtypes = {}

    def loss_fn(p, ms, b):
        if not param_dtypes:
            for path, leaf in F.tree_leaves_with_paths(p):
                kind = "bn" if amp.policy.is_norm_path(path) else "weights"
                param_dtypes.setdefault(kind, set()).add(str(leaf.dtype))
        x, y = b
        logits, new_ms = model.apply(p, ms, x, training=True)
        return torch.mean(softmax_cross_entropy_loss(logits.float(), y)), \
            new_ms

    opt = FusedSGD(lr=0.1, momentum=0.9, weight_decay=1e-4)
    if larc:
        from apex_tpu_torch.parallel.larc import LARC
        opt = LARC(opt, trust_coefficient=0.02, clip=True)
    state = opt.init(params)
    del params
    check((len(opt.spec.sizes), sum(opt.spec.sizes), state.params.numel(),
           len(F.tree_leaves(mstate))) == (161, 25_557_032, RESNET50_FLAT,
                                           106),
          "ResNet-50 layout drifted")
    step = ddp.make_train_step(loss_fn, opt, amp_state=amp_state,
                               with_state=True)
    step.param_dtypes = param_dtypes

    def gen(s):
        return torch.Generator(device="cuda").manual_seed(s)

    x = torch.randn((batch, RESNET_SIZE, RESNET_SIZE, 3), generator=gen(1),
                    device="cuda")
    y = torch.randint(0, 1000, (batch,), generator=gen(2), device="cuda")
    return opt, step, (state, amp_state.loss_scalers[0], mstate), (x, y)


def resnet_phase(torch, xe, wf, ok, steps=5, warmup=2, larc=False,
                 opt_level="O1"):
    """The ResNet-50 AMP-O1 training step at full width (module docstring,
    phase 7; with `larc`, phase 10's LARC leg, which takes no
    kernels-vs-plain step; with `opt_level="O2"`, slice 17's O2 leg,
    whose kernels-vs-plain comparison takes two steps).  Returns the
    measurements, the kernels-vs-plain line (None with `larc`) and the
    flat layout."""
    what = "LARC resnet" if larc else "resnet"
    if opt_level != "O1":
        what += f" {opt_level}"
    opt, step, carry, batch = resnet_setup(torch, RESNET_BATCH, larc=larc,
                                           opt_level=opt_level)

    def carry_step(c, b):
        o, sc, ms, loss = step(*c, b)
        return (o, sc, ms), loss

    bench_was = torch.backends.cudnn.benchmark
    # cuDNN picks each conv's algorithm by timing them on its first call
    # (the warm-up steps), as apex's main_amp.py sets it
    torch.backends.cudnn.benchmark = True
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in resnet_kernels(xe, wf, ok).values():
        fn.launches = 0
    tune_stats(reset=True)
    records = []
    t0 = time.perf_counter()
    for _ in range(warmup):
        carry, loss = carry_step(carry, batch)
        records.append((loss, carry[1].scale, carry[1].found_inf))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(steps):
        carry, loss = carry_step(carry, batch)
        records.append((loss, carry[1].scale, carry[1].found_inf))
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    counts = resnet_counts(xe, wf, ok)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(r[0]) for r in records]
    scales = [float(r[1]) for r in records]
    overflow = [bool(r[2]) for r in records]
    n = warmup + steps
    log(f"{what} losses {losses} loss scale {scales}")
    check(all(math.isfinite(v) for v in losses), f"a {what} loss is not "
          "finite")
    check(losses[-1] < losses[0], f"{what} loss did not fall: {losses}")
    check(not any(overflow), f"a {what} step overflowed: {overflow}")
    check(int(carry[0].step) == n and scales == [65536.0] * n,
          f"SGD step {int(carry[0].step)}, loss scales {scales}")
    # LARC: the per-tensor norms of the params and of the grads
    per_step = {"xent_fwd": 1, "xent_bwd": 1, "sgd": 1, "channel_sums": 53,
                "rows_sumsq_seg": 2 if larc else 0}
    for name, k in per_step.items():
        check(counts[name] == k * n,
              f"{what} {name}: {counts[name]} launches in {n} steps, want "
              f"{k} per step")
    carry, syncs = step_without_sync(torch, carry_step, carry, batch)
    names = {"xent_fwd": lambda k: k == "_xent_fwd_kernel",
             "xent_bwd": lambda k: k == "_xent_bwd_kernel",
             "sgd": lambda k: k == "_sgd_kernel",
             "channel_sums": lambda k: "channel_sums_" in k}
    if larc:
        names["rows_sumsq_seg"] = lambda k: k in ("_sumsq_items_kernel",
                                                  "_sumsq_segments_kernel")
    # the channel sums' shapes in the profiled step, for their bound
    sums_in = []
    channel_sums = wf.channel_sums_cuda

    def record_sums(x2):
        sums_in.append((tuple(x2.shape), x2.element_size(), x2.dtype))
        return channel_sums(x2)

    # the launcher counts its launches on the module global: the recorder
    # carries the count while it stands in
    record_sums.launches = channel_sums.launches
    wf.channel_sums_cuda = record_sums
    try:
        carry, profile_line = profile_step(torch, carry_step, carry,
                                           (batch,), names)
    finally:
        wf.channel_sums_cuda = channel_sums
        channel_sums.launches = record_sums.launches
    shapes = {}
    for shape, _, _ in sums_in:
        shapes[shape] = shapes.get(shape, 0) + 1
    check(shapes == RESNET50_BN_SHAPES,
          f"{what}: the batch norms' shapes {sorted(shapes.items())} are "
          f"not RESNET50_BN_SHAPES")
    log(f"{what}: the batch norms' input dtypes "
        f"{sorted({str(d) for *_, d in sums_in})}")
    # x read once, the fp32 sums and sums of squares written once
    sums_bytes = sum(r * c * el + 2 * 4 * c for (r, c), el, _ in sums_in)
    sums_ms = profile_line["kernels_ms"]["channel_sums"]
    sums_bound = 1e3 * sums_bytes / HBM_BYTES_PER_S
    channel_sums_step = {"launches": len(sums_in), "device_ms": sums_ms,
                         "bound_ms": sums_bound,
                         "share_of_bound": sums_bound / sums_ms}
    log(f"{what} channel sums in one profiled step: "
        + json.dumps(channel_sums_step))
    check(len(sums_in) == per_step["channel_sums"],
          f"{what}: {len(sums_in)} channel sums in the profiled step")
    spec = opt.spec
    param_dtypes, state_dtype = step.param_dtypes, carry[0].params.dtype
    del carry, step, opt
    torch.cuda.empty_cache()
    result = {
        "config": "ResNet-50 (1000 classes, NHWC, conv7 stem), amp O1 "
                  "(bf16 compute, fp32 params, dynamic loss scale 2^16), "
                  "batch 256 x 224 x 224 x 3, "
                  + ("LARC(trust 0.02, clip) around " if larc else "")
                  + "FusedSGD(lr=0.1, momentum 0.9, wd 1e-4)",
        "cudnn_benchmark": True, "params": 25_557_032,
        "warmup_steps": warmup, "steps": steps, "losses": losses,
        "loss_scales": scales, "tune": tune_stats(), "warmup_s": warm_s,
        "step_ms": 1e3 * window_s / steps,
        "img_per_s": RESNET_BATCH * steps / window_s,
        "peak_mem_gib": peak / 2 ** 30, "host_syncs_per_step": len(syncs),
        "launches": counts, "launches_per_step": per_step,
        "channel_sums_step": channel_sums_step, "profile": profile_line}
    if opt_level == "O2":
        dts = {k: sorted(v) for k, v in param_dtypes.items()}
        check(dts == {"bn": ["torch.float32"], "weights": ["torch.bfloat16"]}
              and state_dtype == torch.float32,
              f"O2 step param dtypes {dts}, master {state_dtype}")
        result["step_param_dtypes"] = dts
        result["master_dtype"] = str(state_dtype)
        result["config"] = result["config"].replace(
            "amp O1 (bf16 compute, fp32 params,",
            "amp O2 (bf16 weights and compute, fp32 batch-norm params, the "
            "fp32 master in FusedSGD's flat buffer,")
    vs_plain = None if larc else compare_resnet_step(
        torch, xe, wf, ok, batch=8, opt_level=opt_level,
        steps=2 if opt_level == "O2" else 1)
    torch.backends.cudnn.benchmark = bench_was
    return result, vs_plain, spec


def resnet_trajectory(torch, xe, wf, ok, batch, opt_level="O1", steps=1,
                      plain=False, nudge=False):
    """`steps` full-width ResNet-50 steps (amp `opt_level`) at `batch` from
    `resnet_setup`'s seed-0 weights and data, through the kernels or,
    with `plain`, through their plain versions (swapped in for the run);
    with `nudge`, every element of the fp32 master moved one ULP up
    (`torch.nextafter` toward +inf) before the first step.  Returns, per
    step, (loss, the flat grads the optimizer was handed, the params'
    change from the start, the running statistics), and the flat
    layout."""
    from apex_tpu_torch.optimizers import flat as F

    def plain_sgd(p, buf, g, scalars, *flags):
        pn, bn = ok._sgd_reference(p, buf, g, scalars, *flags)
        p.copy_(pn)
        buf.copy_(bn)
        return p, buf

    swaps = [(xe, "xent_fwd_triton", xe.xent_fwd_reference),
             (xe, "xent_bwd_triton", xe.xent_bwd_reference),
             (wf, "channel_sums_cuda", wf.channel_sums_reference),
             (ok, "sgd_flat_triton", plain_sgd)]
    opt, step, (state, sc, ms), b = resnet_setup(torch, batch,
                                                 opt_level=opt_level)
    if nudge:
        state.params.copy_(torch.nextafter(
            state.params, torch.full_like(state.params, float("inf"))))
    p0 = state.params.clone()
    grads = []
    step_flat = opt.step_flat

    def capture(st, g_flat, **kw):
        grads.append(g_flat.clone())
        return step_flat(st, g_flat, **kw)

    opt.step_flat = capture
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    if plain:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
    out = []
    try:
        for i in range(steps):
            state, sc, ms, loss = step(state, sc, ms, b)
            out.append((float(loss), grads[i], state.params - p0,
                        [x.clone() for x in F.tree_leaves(ms)]))
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return out, opt.spec


def resnet_step_diffs(torch, a, r, spec):
    """Per step, run `a` against run `r` (two `resnet_trajectory`s): the
    losses' relative difference, each leaf's grad and param-change
    relative L2 (median, max and the worst leaf) and the running
    statistics' worst relative L2."""
    def rel_l2(x, y):
        return ((x.float() - y.float()).norm()
                / y.float().norm().clamp_min(1e-30)).item()

    out = []
    for (la, ga, ua, ma), (lr_, gr, ur, mr) in zip(a, r):
        grad_rel, upd_rel = {}, {}
        for path, off, size in zip(spec.paths, spec.offsets, spec.sizes):
            key = "/".join(path)
            grad_rel[key] = rel_l2(ga[off:off + size], gr[off:off + size])
            upd_rel[key] = rel_l2(ua[off:off + size], ur[off:off + size])
        gw = max(grad_rel, key=grad_rel.get)
        uw = max(upd_rel, key=upd_rel.get)
        out.append({
            "loss": la, "loss_ref": lr_,
            "loss_rel_diff": abs(la - lr_) / abs(lr_),
            "grad_rel_l2_max": grad_rel[gw], "grad_rel_l2_worst": gw,
            "grad_rel_l2_median": sorted(grad_rel.values())[
                len(grad_rel) // 2],
            "update_rel_l2_max": upd_rel[uw], "update_rel_l2_worst": uw,
            "running_stats_rel_l2_max": max(rel_l2(x, y)
                                            for x, y in zip(ma, mr))})
    return out


def compare_resnet_step(torch, xe, wf, ok, batch, opt_level="O1", steps=1):
    """`steps` full-width ResNet-50 steps through the kernels and through
    their plain versions from the same weights and data
    (`resnet_trajectory`).  The first step's loss, each leaf's gradient
    and param update (relative L2) and the running statistics are held
    to phase 7's gates.  With more steps, the plain versions run once
    more from the fp32 master nudged one ULP up, and each later step of
    the kernels is held to that nudge's drift: from the second step on,
    any rounding difference in the weights moves the batch-norm grads by
    10-40 % (`--resnet-steps`: the kernels against the plain versions
    and the nudged plain versions drift alike, under O1 as under O2,
    while the plain versions are bit for bit run to run).  A later step's
    grad median, grad max and update max are held within twice the
    nudge's, its running statistics within 1e-2 and its loss within
    1e-2 relative (3.5x the nudge's largest drift over three steps)."""
    before = resnet_counts(xe, wf, ok)
    plain, spec = resnet_trajectory(torch, xe, wf, ok, batch, opt_level,
                                    steps, plain=True)
    nudged = None
    if steps > 1:
        nudged, _ = resnet_trajectory(torch, xe, wf, ok, batch, opt_level,
                                      steps, plain=True, nudge=True)
    check(resnet_counts(xe, wf, ok) == before,
          "the plain ResNet step launched a kernel")
    kern, _ = resnet_trajectory(torch, xe, wf, ok, batch, opt_level, steps)
    torch.cuda.synchronize()
    diffs = resnet_step_diffs(torch, kern, plain, spec)
    d = diffs[0]
    line = {"batch": batch, "opt_level": opt_level, "steps": steps,
            "loss_kernels": d["loss"], "loss_plain": d["loss_ref"],
            **{k: v for k, v in d.items() if k not in ("loss", "loss_ref")}}
    if steps > 1:
        floor = resnet_step_diffs(torch, nudged, plain, spec)
        del nudged
        line["per_step"] = diffs
        line["nudged_plain_per_step"] = floor
    log("resnet step, kernels vs plain versions " + json.dumps(line))
    # the kernels differ from the plain versions by fp32 rounding (sums in
    # another order, the hardware exp): a bf16 activation here and there
    # rounds the other way, and the batch-norm grads, sums of bf16 terms
    # that cancel to a few % of their size, carry that furthest
    check(line["loss_rel_diff"] <= 1e-3, "resnet step loss: kernels vs plain")
    check(line["grad_rel_l2_median"] <= 1e-2
          and line["grad_rel_l2_max"] <= 0.25,
          f"resnet step grads: kernels vs plain "
          f"({line['grad_rel_l2_worst']})")
    check(line["update_rel_l2_max"] <= 0.25,
          f"resnet step params: kernels vs plain "
          f"({line['update_rel_l2_worst']})")
    check(line["running_stats_rel_l2_max"] <= 1e-2,
          "resnet step running stats: kernels vs plain")
    for k in range(1, steps):
        dk, fk = diffs[k], line["nudged_plain_per_step"][k]
        check(all(dk[m] <= 2 * fk[m] for m in (
                  "grad_rel_l2_median", "grad_rel_l2_max",
                  "update_rel_l2_max"))
              and dk["running_stats_rel_l2_max"] <= 1e-2
              and dk["loss_rel_diff"] <= 1e-2,
              f"resnet {opt_level} step {k + 1}: kernels vs plain {dk}, "
              f"against the one-ULP nudge's drift {fk}")
    return line


def resnet_steps_evidence(torch, xe, wf, ok, batch=8, steps=3):
    """`python3 chip_smoke.py --resnet-steps`: how far later ResNet-50
    steps drift apart from rounding alone, under O1 and O2.  For each
    opt level, `steps` steps at `batch` (phase 7's comparison size),
    per step (`resnet_step_diffs`): the kernels against the plain
    versions; the plain versions against themselves (the card's own
    run-to-run); and the plain versions from the fp32 master nudged one
    ULP up against the plain versions.  Prints one JSON line per opt
    level."""
    bench_was = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True        # as resnet_phase runs it
    try:
        for level in ("O1", "O2"):
            base, spec = resnet_trajectory(torch, xe, wf, ok, batch, level,
                                           steps, plain=True)
            out = {"opt_level": level, "batch": batch, "steps": steps}
            for name, kw in (("kernels_vs_plain", {}),
                             ("plain_vs_plain", {"plain": True}),
                             ("plain_nudged_vs_plain",
                              {"plain": True, "nudge": True})):
                run, _ = resnet_trajectory(torch, xe, wf, ok, batch, level,
                                           steps, **kw)
                out[name] = resnet_step_diffs(torch, run, base, spec)
                del run
            del base
            torch.cuda.empty_cache()
            print(json.dumps(out), flush=True)
    finally:
        torch.backends.cudnn.benchmark = bench_was
    return 0


def table_resnet_kernels(torch, xe, wf, ok, rng, errs, resnet, spec):
    """Phase 10 rows of the ResNet step's kernels at the step's shapes:
    the cross entropy at (256, 1000) fp32 logits, SGD over the ResNet-50
    flat buffer (fp32 p and buf, bf16 grads), the channel sums at the
    stem's (3,211,264, 64) bf16 (and, as `ms_smallest_shape`, the last
    stage's (12,544, 2048)).  Launches: the ResNet phase's seven steps.
    `spec`: the ResNet-50 flat layout (the library call's leaf views)."""
    import torch.nn.functional as F

    dev, bf16 = "cuda", torch.bfloat16
    launches, per_step = resnet["launches"], resnet["launches_per_step"]
    rows = []

    def row(name, key, *args):
        rows.append(table_row(name, launches[key], per_step[key],
                              errs[name], *args))

    r, v = RESNET_BATCH, 1000
    x = torch.randn((r, v), generator=rng, device=dev) * 3
    y = torch.randint(0, v, (r,), generator=rng, device=dev,
                      dtype=torch.int32)
    yl = y.long()
    g = torch.full((r,), 1.0 / r, device=dev)
    shape = "logits (256, 1000) fp32, int32 labels, smoothing 0"
    ms = time_ms(torch, lambda: xe.xent_fwd_triton(x, y, 0.0))
    plain = time_ms(torch, lambda: xe.xent_fwd_reference(x, y, 0.0))
    lib = time_ms(torch, lambda: F.cross_entropy(x, yl, reduction="none"))
    row("xent_fwd", "xent_fwd", "triton", "apex_tpu_torch/ops/xentropy.py",
        "apex_tpu/ops/xentropy.py:39", ms, plain, lib,
        "torch.nn.functional.cross_entropy(reduction='none')",
        4 * r * v + 4 * r + 8 * r, 6 * r * v, shape)
    _, lse = xe.xent_fwd_triton(x, y, 0.0)
    ms = time_ms(torch, lambda: xe.xent_bwd_triton(g, x, y, lse, 0.0))
    plain = time_ms(torch, lambda: xe.xent_bwd_reference(g, x, y, lse, 0.0))
    xg = x.detach().requires_grad_(True)
    out = F.cross_entropy(xg, yl, reduction="none")
    lib = time_ms(torch, lambda: torch.autograd.grad(out, xg, g,
                                                     retain_graph=True))
    del out, xg
    row("xent_bwd", "xent_bwd", "triton", "apex_tpu_torch/ops/xentropy.py",
        "apex_tpu/ops/xentropy.py:53", ms, plain, lib,
        "torch.nn.functional.cross_entropy backward (autograd)",
        8 * r * v + 12 * r + 4 * r, 4 * r * v, shape + "; dx fp32")

    n = RESNET50_FLAT
    p = torch.randn((n,), generator=rng, device=dev) * 0.05
    b = torch.randn((n,), generator=rng, device=dev) * 0.01
    gb = (torch.randn((n,), generator=rng, device=dev) * 65536).to(bf16)
    sc = ok._sgd_scalars(0.1, 2.0 ** -16, False, False, device=dev)
    ms = time_ms(torch, lambda: ok.sgd_flat_triton(
        p, b, gb, sc, 0.9, 0.0, False, 1e-4, False, False), n=40)
    plain = time_ms(torch, lambda: ok._sgd_reference(
        p, b, gb, sc, 0.9, 0.0, False, 1e-4, False, False), n=20)
    lib = library = None
    if hasattr(torch, "_fused_sgd_"):
        g32 = gb.float()
        pv, gv, bv = ([t[o:o + k] for o, k in zip(spec.offsets, spec.sizes)]
                      for t in (p, g32, b))
        lib = time_ms(torch, lambda: torch._fused_sgd_(
            pv, gv, bv, weight_decay=1e-4, momentum=0.9, lr=0.1,
            dampening=0.0, nesterov=False, maximize=False,
            is_first_step=False), n=40)
        library = ("torch._fused_sgd_ over the 161 leaf views (fp32 grads: "
                   "it takes one dtype)")
        del g32, pv, gv, bv
    row("sgd", "sgd", "triton", "apex_tpu_torch/ops/optimizer_kernels.py",
        "apex_tpu/ops/optimizer_kernels.py:356", ms, plain, lib, library,
        18 * n + 16, 8 * n,
        f"p, buf ({n},) fp32, g bf16; momentum 0.9, wd 1e-4")
    del p, b, gb

    # the channel sums at every batch-norm shape of the step (bf16), each
    # beside torch.var_mean; the row's own numbers at the stem's shape
    by_shape = {}
    for (rr, c), count in RESNET50_BN_SHAPES.items():
        x2 = torch.randn((rr, c), generator=rng, device=dev).to(bf16)
        by_shape[f"({rr}, {c})"] = {
            "per_step": count,
            "ms": time_ms(torch, lambda: wf.channel_sums_cuda(x2)),
            "library_ms": time_ms(torch, lambda: torch.var_mean(
                x2, dim=0, correction=0)),
            "bound_ms": 1e3 * (2 * rr * c + 8 * c) / HBM_BYTES_PER_S,
            "plan": list(wf.sums_plan(rr, c, 2, wf._sm_count(x2.device)))}
        if (rr, c) == (3_211_264, 64):
            plain = time_ms(torch, lambda: wf.channel_sums_reference(x2))
        del x2
        torch.cuda.empty_cache()
    stem = by_shape["(3211264, 64)"]
    rr, c = 3_211_264, 64
    row("channel_sums", "channel_sums", "cuda",
        "apex_tpu_torch/csrc/welford.cu", "apex_tpu/ops/welford.py:27",
        stem["ms"], plain, stem["library_ms"],
        "torch.var_mean(x2, dim=0, correction=0)",
        2 * rr * c + 8 * c, 3 * rr * c,
        "x (3211264, 64) bf16: the stem's batch norm -> fp32 (64,) x 2")
    small = by_shape["(12544, 2048)"]
    rows[-1].update({
        "plan": stem["plan"], "ms_smallest_shape": small["ms"],
        "bound_ms_smallest_shape": small["bound_ms"], "by_shape": by_shape,
        "ms_a_step": sum(v["per_step"] * v["ms"] for v in by_shape.values()),
        "bound_ms_a_step": sum(v["per_step"] * v["bound_ms"]
                               for v in by_shape.values()),
        "library_ms_a_step": sum(v["per_step"] * v["library_ms"]
                                 for v in by_shape.values())})
    log("channel sums by shape: " + json.dumps(by_shape))
    torch.cuda.empty_cache()
    return rows


def dense_phase(torch, fa, ln, ok):
    """GPT-350M's default dense-attention step with FusedAdam's no-decay
    groups, then BERT-Large's dense step (module docstring, phase 8).
    Returns the measurements and the kernel-vs-plain comparisons."""
    from apex_tpu_torch.models import bert as bert_mod
    from apex_tpu_torch.models import gpt as gpt_mod
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.transformer.pipeline_parallel import (
        get_params_for_weight_decay_optimization as wd_mask)

    bf16 = torch.bfloat16
    check(not gpt_mod.GPTConfig().use_flash_attention, "GPTConfig's "
          "default attention is no longer the dense path")

    def make_adam(params):      # phase 2 checked its 98 decayed tensors
        return FusedAdam(lr=1e-4, weight_decay=0.01, master_dtype=bf16,
                         wd_mask=wd_mask(params))

    def plain_adam_seg(p, m, v, g, scalars, eps, adam_w, seg, wdt, lrt):
        rows = seg.long()
        for buf, new in zip((p, m, v), ok._adam_seg_reference(
                p, m, v, g, scalars, eps, adam_w, wdt[rows], lrt[rows])):
            buf.copy_(new)
        return p, m, v

    per_step = {"softmax_fwd": 24, "softmax_bwd": 24, "layer_norm_fwd": 49,
                "layer_norm_bwd": 49, "adam_seg": 1,
                "flash_attention_fwd": 0, "flash_attention_bwd": 0,
                "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
                "adam": 0}
    names = {"softmax_fwd": lambda k: k == "_softmax_fwd_kernel",
             "softmax_bwd": lambda k: k == "_softmax_bwd_kernel",
             "layer_norm_fwd": lambda k: "ln_fwd_kernel" in k,
             "layer_norm_bwd": lambda k: "ln_bwd_" in k,
             "adam_seg": lambda k: k == "_adam_seg_kernel"}
    gpt, gpt_vs_plain = gpt_train_phase(
        torch, fa, ln, ok, "dense GPT", False, make_adam,
        "FusedAdam(lr=1e-4, wd 0.01, master bf16, no-decay wd_mask: 98 of "
        "292 tensors decay)", [(ok, "adam_flat_seg_triton", plain_adam_seg)],
        per_step, names, warmup=2, steps=5)
    log("dense GPT " + json.dumps(gpt))
    torch.cuda.empty_cache()

    # BERT-Large, phase 6's step with its default (dense) attention
    check(not bert_mod.BertConfig().use_flash_attention, "BertConfig's "
          "default attention is no longer the dense path")
    bert, bert_vs_plain = bert_phase(torch, fa, ln, ok, flash=False,
                                     steps=3)
    log("dense BERT " + json.dumps(bert))
    return gpt, bert, gpt_vs_plain, bert_vs_plain


# bench.py:394-417 `_long_context_32k` on its chip branch: (B, H, S, D)
LONG_SHAPE = (1, 8, 32768, 64)


def check_split_backward(torch, fa, rng, *, b, h, s, d, causal, seg=None):
    """The split backward's two kernels on one bf16 input (module
    docstring, phase 9): against their plain versions on the same lse and
    delta, against autograd through `attention_reference`, and against
    the fused kernel (dk and dv bit for bit, dq within the tolerance);
    the dq pass twice, bit for bit.  `seg`: (b, s) int32 ids for q and
    kv.  Tolerance 1e-2 of each output's largest magnitude, as for the
    fused pair (`check_flash_attention`)."""
    dev, bf16 = "cuda", torch.bfloat16
    q, k, v, do = (torch.randn((b, h, s, d), generator=rng,
                               device=dev).to(bf16) for _ in range(4))
    sc = 1.0 / math.sqrt(d)
    o, lse = fa.flash_fwd_cuda(q, k, v, sc, causal, seg, seg)
    delta = torch.sum(do.float() * o.float(), dim=-1)
    args = (q, k, v, do, lse, delta, sc, causal, seg, seg)
    dq = fa.flash_bwd_dq_cuda(*args)
    dq_again = fa.flash_bwd_dq_cuda(*args)
    dk, dv = fa.flash_bwd_dkv_cuda(*args)
    fdq, fdk, fdv = fa.flash_bwd_cuda(*args)
    pdq = fa.flash_bwd_dq_reference(*args)
    pdk, pdv = fa.flash_bwd_dkv_reference(*args)
    qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))
    fa.attention_reference(qr, kr, vr, causal=causal, softmax_scale=sc,
                           q_segment_ids=seg,
                           kv_segment_ids=seg).backward(do)
    torch.cuda.synchronize()
    case = f"({b},{h},{s},{d}) causal={causal} seg={seg is not None}"
    check(all(t.dtype == bf16 for t in (dq, dk, dv)), f"split {case} dtype")
    check(torch.equal(dq, dq_again), f"dq pass {case}: two runs differ")
    check(torch.equal(dk, fdk) and torch.equal(dv, fdv),
          f"dk/dv pass {case}: dk, dv differ from the fused kernel's")
    errs = {}
    for name, got, refs in (
            ("dq", dq, {"plain": pdq, "autograd": qr.grad, "fused": fdq}),
            ("dk", dk, {"plain": pdk, "autograd": kr.grad}),
            ("dv", dv, {"plain": pdv, "autograd": vr.grad})):
        for ref_name, ref in refs.items():
            errs[f"{name}_vs_{ref_name}"] = max_err(
                torch, f"split {name} {case} vs {ref_name}", got, ref)
    return errs


def long_context_leg(torch, fa, ln, ok, rng, warmup=1, iters=5):
    """bench.py's `_long_context_32k` at LONG_SHAPE: the gradient of
    flash_attention(q, k, v, causal=True).float().mean() through the
    entry point and autograd, `warmup` + `iters` timed iterations.  The
    counters must show one forward, one dq pass, one dk/dv pass and no
    fused backward per iteration; the result is held against the fused
    kernel on the same inputs (dk, dv bit for bit, dq within 1e-2 of its
    largest magnitude)."""
    b, h, s, d = LONG_SHAPE
    bf16 = torch.bfloat16
    sc = 1.0 / math.sqrt(d)
    q, k, v = (torch.randn(LONG_SHAPE, generator=rng, device="cuda")
               .to(bf16).requires_grad_(True) for _ in range(3))

    def grad():
        loss = fa.flash_attention(q, k, v, causal=True).float().mean()
        return torch.autograd.grad(loss, (q, k, v))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts(fa, ln, ok)
    for _ in range(warmup):
        out = grad()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = grad()
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    peak = torch.cuda.max_memory_allocated()
    counts = kernel_counts(fa, ln, ok)
    n = warmup + iters
    per_iter = {"flash_attention_fwd": 1, "flash_attention_bwd": 0,
                "flash_attention_bwd_dq": 1, "flash_attention_bwd_dkv": 1}
    for name, want in per_iter.items():
        check(counts[name] == want * n, f"32k leg {name}: {counts[name]} "
              f"launches in {n} iterations, want {want} each")
    # the fused route on the same inputs: do = d mean / d o = 2^-24
    with torch.no_grad():
        o, lse = fa.flash_fwd_cuda(q, k, v, sc, True)
        do = torch.full_like(o, 1.0 / o.numel())
        delta = torch.sum(do.float() * o.float(), dim=-1)
        fdq, fdk, fdv = fa.flash_bwd_cuda(q, k, v, do, lse, delta, sc, True)
    torch.cuda.synchronize()
    dq, dk, dv = out
    check(all(bool(torch.isfinite(t).all()) for t in out),
          "32k leg: a gradient is not finite")
    check(torch.equal(dk, fdk) and torch.equal(dv, fdv),
          "32k leg: dk, dv differ from the fused route's")
    line = {"shape": list(LONG_SHAPE), "causal": True, "warmup": warmup,
            "iters": iters, "ms": 1e3 * dt, "tokens_per_s": b * s / dt,
            "peak_mem_gib": peak / 2 ** 30,
            "launches": {k_: counts[k_] for k_ in per_iter},
            "launches_per_iter": per_iter,
            "dk_dv_equal_fused_bitwise": True,
            "dq_vs_fused_max_err": max_err(torch, "32k leg dq vs fused", dq,
                                           fdq),
            "dq_max": fdq.float().abs().max().item()}
    del q, k, v, out, o, lse, do, delta, fdq, fdk, fdv, dq, dk, dv
    torch.cuda.empty_cache()
    return line


def route_times(torch, fa, rng):
    """Both backward routes timed by calling the launchers (CUDA events,
    warm L2): the fused kernel (with its dq scratch zeroing and cast)
    against the dq pass plus the dk/dv pass, at LONG_SHAPE and at GPT's
    (12, 16, 1024, 64), causal: what the card says of the cap."""
    out = {}
    for label, shape, n in (("32k", LONG_SHAPE, 10),
                            ("gpt_1024", (12, 16, 1024, 64), 40)):
        q, k, v, do = (torch.randn(shape, generator=rng, device="cuda")
                       .to(torch.bfloat16) for _ in range(4))
        sc = 1.0 / math.sqrt(shape[3])
        o, lse = fa.flash_fwd_cuda(q, k, v, sc, True)
        delta = torch.sum(do.float() * o.float(), dim=-1)
        args = (q, k, v, do, lse, delta, sc, True)
        fused = time_ms(torch, lambda: fa.flash_bwd_cuda(*args), n=n)
        split = time_ms(torch, lambda: (fa.flash_bwd_dq_cuda(*args),
                                        fa.flash_bwd_dkv_cuda(*args)), n=n)
        dq_ms = time_ms(torch, lambda: fa.flash_bwd_dq_cuda(*args), n=n)
        dkv_ms = time_ms(torch, lambda: fa.flash_bwd_dkv_cuda(*args), n=n)
        out[label] = {"shape": list(shape), "route_by_cap":
                      fa.backward_route(shape[2], shape[3]),
                      "fused_ms": fused, "split_ms": split, "dq_ms": dq_ms,
                      "dkv_ms": dkv_ms, "split_over_fused": split / fused}
        del q, k, v, do, o, lse, delta
    torch.cuda.empty_cache()
    return out


def long_phase(torch, fa, ln, ok, rng):
    """Phase 9 (module docstring): the split backward's kernel checks,
    the 32k leg, the GPT-350M step at seq 8192, and both routes' times.
    Returns the measurements and the GPT step's kernels-vs-plain line."""
    checks = {}
    for b, h, s, d, causal in ((1, 8, 8192, 64, True),
                               (1, 8, 8192, 64, False),
                               (1, 8, 8192, 128, True),
                               (1, 8, 8192, 128, False)):
        e = check_split_backward(torch, fa, rng, b=b, h=h, s=s, d=d,
                                 causal=causal)
        checks[f"({b},{h},{s},{d}) causal={causal}"] = e
        log(f"split backward ({b},{h},{s},{d}) causal={causal}: {e}")
    # BERT's padding: 4608, 3000 and 1 real tokens and a sequence that is
    # padding from end to end (its pads see only each other)
    seg = pad_segments(torch, 4, 4608, [4608, 3000, 1, 0])
    for causal in (False, True):
        e = check_split_backward(torch, fa, rng, b=4, h=8, s=4608, d=64,
                                 causal=causal, seg=seg)
        checks[f"(4,8,4608,64) causal={causal} padding"] = e
        log(f"split backward (4,8,4608,64) causal={causal} padding: {e}")
    del seg
    torch.cuda.empty_cache()
    leg = long_context_leg(torch, fa, ln, ok, rng)
    log("32k leg " + json.dumps(leg))
    gpt, gpt_vs_plain = flash_gpt_phase(torch, fa, ln, ok, "long GPT",
                                        "split", warmup=2, steps=3,
                                        batch=1, seq=8192)
    log("long GPT " + json.dumps(gpt))
    torch.cuda.empty_cache()
    routes = route_times(torch, fa, rng)
    log("backward routes " + json.dumps(routes))
    return {"checks": checks, "leg": leg, "gpt": gpt,
            "routes": routes}, gpt_vs_plain


def table_long_kernels(torch, fa, rng, long):
    """Phase 10 rows of the split backward's kernels at LONG_SHAPE (the
    32k leg's shape; kernel times from `route_times`), with their times
    at GPT-350M's seq 8192 (1, 16, 8192, 64), both causal.  Bounds count
    the score pairs at or below the diagonal: the dq pass does 3
    products of 2d flop a pair, the dk/dv pass 4.  Launches: the 32k
    leg's and the seq-8192 GPT phase's.  Library: one SDPA backward
    (autograd) at the same shape, which computes dq, dk and dv, and at
    seq 8192."""
    import torch.nn.functional as F

    bf16 = torch.bfloat16
    leg, gpt, routes = long["leg"], long["gpt"], long["routes"]["32k"]
    b, h, s, d = LONG_SHAPE
    sc = 1.0 / math.sqrt(d)
    q, k, v, do = (torch.randn(LONG_SHAPE, generator=rng, device="cuda")
                   .to(bf16) for _ in range(4))
    o, lse = fa.flash_fwd_cuda(q, k, v, sc, True)
    delta = torch.sum(do.float() * o.float(), dim=-1)
    args = (q, k, v, do, lse, delta, sc, True)
    errs = {"dq": max_err(torch, "32k dq vs plain", fa.flash_bwd_dq_cuda(
        *args), fa.flash_bwd_dq_reference(*args))}
    pdk, pdv = fa.flash_bwd_dkv_reference(*args)
    dk, dv = fa.flash_bwd_dkv_cuda(*args)
    errs["dkv"] = max(max_err(torch, "32k dk vs plain", dk, pdk),
                      max_err(torch, "32k dv vs plain", dv, pdv))
    del pdk, pdv, dk, dv
    plain = {"dq": time_ms(torch, lambda: fa.flash_bwd_dq_reference(*args),
                           n=3, warm=1),
             "dkv": time_ms(torch, lambda: fa.flash_bwd_dkv_reference(
                 *args), n=3, warm=1)}
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                         scale=sc)
    lib = time_ms(torch, lambda: torch.autograd.grad(
        out, (qg, kg, vg), do, retain_graph=True), n=10)
    del out, qg, kg, vg, q, k, v, do, o, lse, delta
    torch.cuda.empty_cache()
    # the same kernels at GPT-350M's seq 8192 (16 heads), as its step runs
    gshape = (1, 16, 8192, 64)
    gq, gk, gv, gdo = (torch.randn(gshape, generator=rng, device="cuda")
                       .to(bf16) for _ in range(4))
    go, glse = fa.flash_fwd_cuda(gq, gk, gv, sc, True)
    gdelta = torch.sum(gdo.float() * go.float(), dim=-1)
    gargs = (gq, gk, gv, gdo, glse, gdelta, sc, True)
    at_8192 = {"dq": time_ms(torch, lambda: fa.flash_bwd_dq_cuda(*gargs)),
               "dkv": time_ms(torch, lambda: fa.flash_bwd_dkv_cuda(*gargs))}
    fused_8192 = time_ms(torch, lambda: fa.flash_bwd_cuda(*gargs))
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (gq, gk, gv))
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                         scale=sc)
    lib_8192 = time_ms(torch, lambda: torch.autograd.grad(
        out, (qg, kg, vg), gdo, retain_graph=True))
    del out, qg, kg, vg
    del gq, gk, gv, gdo, go, glse, gdelta, gargs
    torch.cuda.empty_cache()

    def pairs(bb, hh, ss):
        return bb * hh * ss * (ss + 1) // 2           # causal score pairs

    el, io = 2, b * h * s * d * 2
    rows = []
    for key, name, replaces, products, outs in (
            ("dq", "flash_attention_bwd_dq",
             "apex_tpu/ops/flash_attention.py:447", 3, 1),
            ("dkv", "flash_attention_bwd_dkv",
             "apex_tpu/ops/flash_attention.py:497", 4, 2)):
        counter = f"flash_attention_bwd_{key}"
        launches = leg["launches"][counter] + gpt["launches"][counter]
        row = table_row(
            name, launches, gpt["launches_per_step"][counter], errs[key],
            "cuda", "apex_tpu_torch/csrc/flash_attention.cu", replaces,
            routes[f"{key}_ms"], plain[key], lib,
            "scaled_dot_product_attention(is_causal=True) backward "
            "(autograd: dq, dk and dv)",
            (4 + outs) * io + 2 * b * h * s * 4,
            2 * products * d * pairs(b, h, s),
            f"q, k, v, do {LONG_SHAPE} bf16, causal; lse, delta fp32")
        row.update({
            "launches_32k_leg": leg["launches"][counter],
            "launches_gpt_seq8192": gpt["launches"][counter],
            "ms_at_gpt_seq8192": at_8192[key],
            "bound_ms_at_gpt_seq8192": 1e3 * 2 * products * d
            * pairs(1, 16, 8192) / BF16_FLOPS,
            "library_ms_at_gpt_seq8192": lib_8192,
            "fused_route_ms_32k": routes["fused_ms"],
            "split_route_ms_32k": routes["split_ms"],
            "fused_route_ms_gpt_seq8192": fused_8192})
        rows.append(row)
    return rows


# ------------------------------------------------ phase 10: slice 7 ----

def adagrad_phase(torch, fa, ln, ok):
    """Phase 5's flash GPT-350M step (batch 12 x seq 1024, bf16 logits)
    with FusedAdagrad(lr=1e-3) through `make_tp_dp_train_step` (module
    docstring, phase 10): two warm-up and three timed steps, one Adagrad
    launch a step and no Adam."""
    from apex_tpu_torch.optimizers import FusedAdagrad

    def plain_adagrad(p, h, g, lr, eps, weight_decay, w_mode):
        pn, hn = ok._adagrad_reference(p, h, g, lr, eps, weight_decay,
                                       w_mode)
        p.copy_(pn)
        h.copy_(hn)
        return p, h

    per_step = {"flash_attention_fwd": 24, "flash_attention_bwd": 24,
                "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
                "layer_norm_fwd": 49, "layer_norm_bwd": 49, "adagrad": 1,
                "adam": 0, "adam_seg": 0}
    names = {"flash_attention_fwd": lambda k: "flash_fwd_kernel" in k,
             "flash_attention_bwd": lambda k: "flash_bwd_kernel" in k,
             "layer_norm_fwd": lambda k: "ln_fwd_kernel" in k,
             "layer_norm_bwd": lambda k: "ln_bwd_" in k,
             "adagrad": lambda k: k == "_adagrad_kernel"}
    return gpt_train_phase(
        torch, fa, ln, ok, "adagrad GPT", True,
        lambda params: FusedAdagrad(lr=1e-3),
        "FusedAdagrad(lr=1e-3; fp32 params and sum of squares)",
        [(ok, "adagrad_flat_triton", plain_adagrad)], per_step, names,
        warmup=2, steps=3, lr=1e-3)


def novograd_phase(torch, fa, ln, ok, warmup=2, steps=3):
    """Phase 6's BERT-Large step (flash attention, batch 32 x seq 512)
    with FusedNovoGrad(lr=1e-3, betas=(0.95, 0.98), wd 0.01,
    grad_averaging) (module docstring, phase 10): one per-tensor
    sums-of-squares launch a step, no LAMB kernel, no host sync."""
    from apex_tpu_torch.models import bert as bert_mod
    from apex_tpu_torch.optimizers import FusedNovoGrad
    from apex_tpu_torch.transformer.training import (
        init_sharded_optimizer, make_tp_dp_train_step)

    cfg = bert_mod.BertConfig(seq_len=BERT_SEQ, dtype=torch.bfloat16,
                              use_flash_attention=True)
    model = bert_mod.Bert(cfg)

    def loss_fn(p, t, lab):
        return model.loss(p, t, lab[0], lab[1], lab[2])

    params = model.init(seed=0)
    opt = FusedNovoGrad(lr=1e-3, betas=(0.95, 0.98), weight_decay=0.01,
                        grad_averaging=True)
    state = init_sharded_optimizer(opt, model, params)
    del params
    step = make_tp_dp_train_step(model, opt, loss_fn=loss_fn)
    tokens, labels = bert_data(torch, cfg, BERT_BATCH)
    per_step = {"flash_attention_fwd": 24, "flash_attention_bwd": 24,
                "layer_norm_fwd": 50, "layer_norm_bwd": 50,
                "rows_sumsq_seg": 1, "lamb_phase1": 0, "lamb_phase1_seg": 0,
                "lamb_phase2_seg": 0, "lamb_phase2_flat": 0, "adam": 0,
                "adam_seg": 0}
    state, result = train_loop(torch, fa, ln, ok, "novograd BERT", step,
                               state, (tokens, labels), per_step, warmup,
                               steps)
    check(int(state.step) == warmup + steps,
          f"NovoGrad step {int(state.step)}")
    state, syncs = step_without_sync(torch, step, state, tokens, labels)
    names = {"flash_attention_fwd": lambda k: "flash_fwd_kernel" in k,
             "flash_attention_bwd": lambda k: "flash_bwd_kernel" in k,
             "layer_norm_fwd": lambda k: "ln_fwd_kernel" in k,
             "layer_norm_bwd": lambda k: "ln_bwd_" in k,
             "rows_sumsq_seg": lambda k: k in ("_sumsq_items_kernel",
                                               "_sumsq_segments_kernel")}
    state, profile_line = profile_step(torch, step, state, (tokens, labels),
                                       names)
    del state, opt, step
    torch.cuda.empty_cache()
    return dict(result, config=(
        "BERT-Large bf16, batch 32 x seq 512, flash attention, fp32 MLM "
        "logits, MLM + NSP, FusedNovoGrad(lr=1e-3, betas (0.95, 0.98), wd "
        "0.01, grad_averaging; fp32 params)"),
        seq_per_s=BERT_BATCH * steps / result["window_s"],
        host_syncs_per_step=len(syncs), profile=profile_line)


def dense_fwd_bwd(torch, fn, x, params):
    """y = fn(x), mean(y²) (a loss that is positive and does not cancel)
    and its grads of x and `params`."""
    y = fn(x)
    loss = torch.mean(torch.square(y.float()))
    grads = torch.autograd.grad(loss, [x] + params)
    return y.detach(), loss.detach(), grads


def mlp_phase(torch, fdn, iters=5):
    """FusedDenseGeluDense(1024, 4096, 1024) in bf16 over GPT-350M's
    (12288, 1024) tokens, and apex's run_mlp MLP([480, 1024, 1024, 512,
    256, 1], relu) at batch 1024 in fp32 and bf16 (module docstring,
    phase 10): forward and backward through the kernel, one warm-up and
    `iters` timed iterations, the launches a forward counted, and the
    output, loss and grads against the same run with the kernel's
    launcher swapped for its plain version (`linear_bias_reference`).
    Limits: the output within 1e-2 (16-bit) or 1e-5 (fp32) of its
    largest magnitude, the loss within the same relative to itself; the
    fp32 grads within 1e-5 of each tensor's largest magnitude, the
    16-bit grads within 3e-2 relative L2 each, as the train steps'
    kernels-vs-plain comparisons hold them (one-ulp differences in a
    layer's bf16 output flip the next ReLU where its input is near 0,
    which moves single elements of the grads below it by their own size
    but the tensor by < 1 %: the MLP's dx by 4-7 % at its largest
    element, 0.3 % relative L2, in a CPU simulation of the two
    roundings).  Beside the wall ms an iteration, the card's: `time_ms`
    of an iteration with the host enqueued ahead (the leg is host-bound,
    so only the card's time shows its kernels).  Returns the
    measurements."""
    from apex_tpu_torch.ops.fused_dense import FusedDenseGeluDense
    from apex_tpu_torch.ops.mlp import MLP

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(3)
    out = {}
    # the routes of a forward's launches: both GPT-350M MLP shapes on
    # wgmma; every MLP layer but the last (N = 1, on the GEMV kernel) on
    # the fp32 kernel or wgmma
    cases = [("fused_dense_gelu_dense", lambda dt: FusedDenseGeluDense(
        1024, 4096, 1024, dtype=dt), (12288, 1024), torch.bfloat16,
        {"wgmma": 2})]
    for dt, routes in ((torch.float32, {"fma": 4, "gemv": 1}),
                       (torch.bfloat16, {"wgmma": 4, "gemv": 1})):
        cases.append((f"mlp_{str(dt)[6:]}", lambda dt: MLP(
            [480, 1024, 1024, 512, 256, 1], activation="relu", dtype=dt),
            (1024, 480), dt, routes))
    for name, make, shape, dt, routes in cases:
        per_fwd = sum(routes.values())
        mod = make(dt)
        params = list(mod.parameters())
        x = torch.randn(shape, generator=gen, device=dev).to(dt)
        x.requires_grad_(True)
        before = fdn.linear_bias_cuda.launches
        by_route = dict(fdn.linear_bias_cuda.route_launches)
        y, loss, grads = dense_fwd_bwd(torch, mod, x, params)
        torch.cuda.synchronize()
        check(fdn.linear_bias_cuda.launches - before == per_fwd,
              f"{name}: {fdn.linear_bias_cuda.launches - before} GEMM "
              f"launches a forward, want {per_fwd}")
        moved = {r: n - by_route[r] for r, n in
                 fdn.linear_bias_cuda.route_launches.items()
                 if n != by_route[r]}
        check(moved == routes, f"{name}: routes {moved}, want {routes}")
        saved = fdn.linear_bias_cuda
        fdn.linear_bias_cuda = (lambda x2, w, b, act:
                                fdn.linear_bias_reference(x2, w, b, act))
        try:
            y_p, loss_p, grads_p = dense_fwd_bwd(torch, mod, x, params)
        finally:
            fdn.linear_bias_cuda = saved
        torch.cuda.synchronize()
        check(fdn.linear_bias_cuda.launches - before == per_fwd,
              f"{name}: the plain run launched the kernel")
        tol = 1e-5 if dt == torch.float32 else 1e-2
        y_err = ((y.float() - y_p.float()).abs().max()
                 / y_p.float().abs().max()).item()
        loss_rel = abs(float(loss) - float(loss_p)) / abs(float(loss_p))
        grad_max = [((a.float() - r.float()).abs().max()
                     / r.float().abs().max()).item()
                    for a, r in zip(grads, grads_p)]
        grad_l2 = [((a.float() - r.float()).norm()
                    / r.float().norm()).item()
                   for a, r in zip(grads, grads_p)]
        grads_ok = (max(grad_max) <= tol if dt == torch.float32
                    else max(grad_l2) <= 3e-2)
        check(y_err <= tol and loss_rel <= tol and grads_ok,
              f"{name}: kernel vs plain output {y_err:.3e}, loss "
              f"{loss_rel:.3e} (limit {tol}), grads max {grad_max}, "
              f"relative L2 {grad_l2}")
        t0 = time.perf_counter()
        for _ in range(iters):
            dense_fwd_bwd(torch, mod, x, params)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / iters
        device_ms = time_ms(torch, lambda: dense_fwd_bwd(torch, mod, x,
                                                         params),
                            n=10, warm=1)
        out[name] = {"shape": list(shape), "dtype": str(dt),
                     "launches_per_forward": per_fwd,
                     "routes_per_forward": routes, "fwd_bwd_ms": ms,
                     "fwd_bwd_device_ms": device_ms,
                     "out_max_err_vs_plain": y_err,
                     "loss_rel_diff_vs_plain": loss_rel,
                     "grad_max_err_vs_plain": max(grad_max),
                     "grad_rel_l2_vs_plain": max(grad_l2)}
        del mod, params, x, y, y_p, grads, grads_p
    out["launches"] = fdn.linear_bias_cuda.launches
    out["route_launches"] = dict(fdn.linear_bias_cuda.route_launches)
    torch.cuda.empty_cache()
    return out


def gemm_host_us(torch, fn, n=50):
    """Host microseconds a call of `fn` takes to enqueue (the wrapper's
    checks, the output's allocation, the tensor maps, the launch), with
    the card held busy by a sleep so no call waits on it."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(1e9))
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / n
    torch.cuda.synchronize()
    return us


# apex's run_mlp layers at batch 1024 (`MLP([480, 1024, 1024, 512, 256,
# 1])`): (m, k, n), relu on all but the last
MLP_LAYERS = ((1024, 480, 1024), (1024, 1024, 1024), (1024, 1024, 512),
              (1024, 512, 256), (1024, 256, 1))


def gemm_route_times(torch, fdn, rng, mlp, errs):
    """The fused dense GEMM's other three kernels at the MLP leg's shapes,
    as rows of the kernel table: `fma` (the fp32 kernel) at the fp32
    MLP's four wide layers, `gemv` at the last layer (N = 1) in fp32 and
    bf16, and `mma` (`mma.sync`) at one shape it still takes (the bf16
    MLP's 1024 x 1024 x 1024 layer on a view of x one element into a
    buffer, which TMA cannot address; no main path launches it); each
    with the plan it ran, beside its bound (bytes once, or 2mnk at the
    fp32 / bf16 peak), its plain version and `torch.addmm` (+ relu) on
    the same inputs.  The kernel is timed with the bias already in fp32,
    its operand (the wrapper converts a 16-bit bias first: one more
    launch, a large share of the GEMV's few microseconds).  Launches: the
    MLP leg's, by route."""
    rows = []
    cases = [(shape, torch.float32, "fma") for shape in MLP_LAYERS[:4]]
    cases += [(MLP_LAYERS[4], torch.float32, "gemv"),
              (MLP_LAYERS[4], torch.bfloat16, "gemv"),
              (MLP_LAYERS[1], torch.bfloat16, "mma")]
    per_fwd = {"fma": 4, "gemv": 1, "mma": 0}
    for (m, k, n), dt, route in cases:
        act = "relu" if n != 1 else None
        x = torch.randn((m, k), generator=rng, device="cuda").to(dt)
        buf = None
        if route == "mma":  # the same values one element into a buffer
            buf = torch.empty(m * k + 8, dtype=dt, device="cuda")
            buf[1:1 + m * k].copy_(x.reshape(-1))
            x = buf[1:1 + m * k].view(m, k)
        w = (torch.randn((k, n), generator=rng, device="cuda")
             / math.sqrt(k)).to(dt)
        b = torch.randn((n,), generator=rng, device="cuda").to(dt)
        check(fdn.gemm_route(dt, m, n, k, x.data_ptr(), w.data_ptr())
              == route, f"GEMM ({m},{k},{n}) {dt}: not the {route} route")
        b32 = b.float()
        ms = time_ms(torch, lambda: fdn.linear_bias_cuda(x, w, b32, act))
        plan = dict(fdn.linear_bias_cuda.last_plan)
        plain = time_ms(torch, lambda: fdn.linear_bias_reference(
            x, w, b, act), n=20)
        if act:
            lib = time_ms(torch, lambda: torch.relu(torch.addmm(b, x, w)))
        else:
            lib = time_ms(torch, lambda: torch.addmm(b, x, w))
        el = x.element_size()
        dname = str(dt)[6:]
        row = table_row(
            f"fused_dense_{route}_{m}x{k}x{n}_{dname}",
            mlp["route_launches"][route], per_fwd[route],
            errs[f"fused_dense_{route}"], "cuda",
            "apex_tpu_torch/csrc/fused_dense.cu",
            "apex_tpu/ops/fused_dense.py:55", ms, plain, lib,
            "torch.addmm" + (" + relu" if act else ""),
            (m * k + k * n + m * n) * el + 4 * n, 2 * m * n * k,
            f"x ({m},{k}) . w ({k},{n}) {dname} + b, act {act}"
            + (", x one element into a buffer" if buf is not None else ""),
            peak=FP32_FLOPS if dt == torch.float32 else BF16_FLOPS)
        row.update({"gemm_route": route, "plan": plan})
        rows.append(row)
        del x, w, b, b32, buf
    return rows


def table_slice7_kernels(torch, ok, fdn, rng, errs, adagrad, mlp, gpt_n,
                         bert_layout):
    """Phase 11 rows of this slice's kernels: Adagrad over the GPT-350M
    flat buffer (fp32 p and h, bf16 grads); the per-element LAMB phase 2
    over the BERT-Large buffer (bf16 p and u, fp32 r); the fused dense
    GEMM at GPT-350M's two MLP shapes in bf16 (the up projection with
    its bias and gelu, the down projection with its bias: the wgmma
    kernel), then its fp32, GEMV and mma.sync kernels at the MLP leg's
    shapes (`gemm_route_times`).  Launches: the Adagrad step's five
    steps; `lamb_phase2_flat` has no caller on a main path (0); the
    GEMM's from the MLP leg."""
    import torch.nn.functional as F

    dev, bf16 = "cuda", torch.bfloat16
    rows = []
    n = gpt_n
    p = torch.randn((n,), generator=rng, device=dev) * 0.05
    h = torch.randn((n,), generator=rng, device=dev).abs() * 1e-3
    g = (torch.randn((n,), generator=rng, device=dev) * 0.1).to(bf16)
    lr = torch.full((), 1e-3, device=dev)
    ms = time_ms(torch, lambda: ok.adagrad_flat_triton(
        p, h, g, lr, 1e-10, 0.0, False), n=40)
    plain = time_ms(torch, lambda: ok._adagrad_reference(
        p, h, g, lr, 1e-10, 0.0, False), n=20)
    param = torch.nn.Parameter(p.clone())
    param.grad = g.float()
    lib_opt = torch.optim.Adagrad([param], lr=1e-3, foreach=True)
    lib = time_ms(torch, lib_opt.step, n=40)
    del param, lib_opt
    rows.append(table_row(
        "adagrad", adagrad["launches"]["adagrad"], 1, errs["adagrad"],
        "triton", "apex_tpu_torch/ops/optimizer_kernels.py",
        "apex_tpu/ops/optimizer_kernels.py:455", ms, plain, lib,
        "torch.optim.Adagrad(foreach=True).step over the one flat fp32 "
        "param (fp32 grads: it takes the param's dtype)", 18 * n + 4,
        7 * n, f"p, h ({n},) fp32, g bf16; wd 0"))
    del p, h, g

    spec, n = bert_layout[0], bert_layout[1]
    p = (torch.randn((n,), generator=rng, device=dev) * 0.05).to(bf16)
    u = (torch.randn((n,), generator=rng, device=dev) * 0.01).to(bf16)
    r = ok.expand_per_tensor_aligned(
        0.5 + torch.rand(len(spec.sizes), generator=rng, device=dev),
        spec, n)
    lr = torch.full((), 1e-2, device=dev)
    ms = time_ms(torch, lambda: ok.lamb_phase2_flat_triton(p, u, r, lr),
                 n=40)
    plain = time_ms(torch, lambda: ok._lamb_phase2_flat_reference(
        p, u, r, lr), n=20)
    lib = time_ms(torch, lambda: p.addcmul_(r, u, value=-1e-2), n=40)
    rows.append(table_row(
        "lamb_phase2_flat", 0, 0, errs["lamb_phase2_flat"], "triton",
        "apex_tpu_torch/ops/optimizer_kernels.py",
        "apex_tpu/ops/optimizer_kernels.py:554", ms, plain, lib,
        "p.addcmul_(r, u, value=-lr)", 10 * n + 4, 3 * n,
        f"p, u ({n},) bf16 (the BERT-Large buffer), r fp32"))
    del p, u, r

    for (m, k, nn), act in (((12288, 1024, 4096), "gelu"),
                            ((12288, 4096, 1024), None)):
        x = torch.randn((m, k), generator=rng, device=dev).to(bf16)
        w = (torch.randn((k, nn), generator=rng, device=dev)
             / math.sqrt(k)).to(bf16)
        b = torch.randn((nn,), generator=rng, device=dev).to(bf16)
        ms = time_ms(torch, lambda: fdn.linear_bias_cuda(x, w, b, act))
        plain = time_ms(torch, lambda: fdn.linear_bias_reference(
            x, w, b, act), n=20)
        if act == "gelu":
            lib = time_ms(torch, lambda: F.gelu(torch.addmm(b, x, w),
                                                approximate="tanh"))
            library = "torch.addmm + F.gelu(approximate='tanh')"
        else:
            lib = time_ms(torch, lambda: torch.addmm(b, x, w))
            library = "torch.addmm"
        row = table_row(
            f"fused_dense_{m}x{k}x{nn}", mlp["launches"], 2,
            errs["fused_dense"], "cuda", "apex_tpu_torch/csrc/fused_dense.cu",
            "apex_tpu/ops/fused_dense.py:55", ms, plain, lib, library,
            2 * (m * k + k * nn + m * nn) + 2 * nn, 2 * m * nn * k,
            f"x ({m},{k}) . w ({k},{nn}) bf16 + b, act {act}",
            peak=BF16_FLOPS)
        # the host cost of a call: this route (three TMA tensor maps built
        # a call) against the same call on the mma.sync route (none), x
        # one element into a buffer so that the route takes it
        buf = torch.empty(m * k + 8, dtype=bf16, device=dev)
        x_mma = buf[1:1 + m * k].view(m, k)
        x_mma.copy_(x)
        check(fdn.gemm_route(bf16, m, nn, k, x_mma.data_ptr(),
                             w.data_ptr()) == "mma", "misaligned x route")
        row.update({"gemm_route": "wgmma",
                    "route_launches": mlp["route_launches"],
                    "host_us_per_call": gemm_host_us(
                        torch, lambda: fdn.linear_bias_cuda(x, w, b, act)),
                    "host_us_per_call_mma_route": gemm_host_us(
                        torch, lambda: fdn.linear_bias_cuda(x_mma, w, b,
                                                            act), n=10)})
        rows.append(row)
        del x, w, b, buf, x_mma
    rows += gemm_route_times(torch, fdn, rng, mlp, errs)
    torch.cuda.empty_cache()
    return rows


# ------------------------------------------------ phase 11: slice 8 ----
#
# The head-packed flash kernels (hp heads of one batch row a block) and the
# generic elementwise launcher: their phase-2 checks, the tuned MHA leg and
# the GPT-350M / BERT-Large steps at attn_heads_per_step=2, and their rows
# of the kernel table.

MHA_SHAPE = (8, 16, 2048, 64)    # bench.py:236, _mha_latencies on the chip
EW_N = 100_000_037               # the elementwise checks' buffers (fp32)
# packed dq against the hp=1 kernel's: one bf16 ulp of its largest
# magnitude (2^-8).  Both sum dq in fp32 with atomics in an order that
# changes from run to run, then round once to bf16.
PACKED_DQ_TOL = 2.0 ** -8


def flash_inputs(torch, rng, b, h, s, d, views):
    """q, k, v, do in bf16 on the card; `views` lays q, k, v out as the
    training path does (strided views of one (S, B, 3H) tensor, do a
    permuted view)."""
    from apex_tpu_torch.ops.fused_dense import qkv_split_heads

    bf16 = torch.bfloat16
    if views:
        qkv = torch.randn((s, b, 3 * h * d), generator=rng,
                          device="cuda").to(bf16)
        q, k, v = qkv_split_heads(qkv, h, d)
        do = torch.randn((s, b, h, d), generator=rng,
                         device="cuda").to(bf16).permute(1, 2, 0, 3)
        return q, k, v, do
    return tuple(torch.randn((b, h, s, d), generator=rng, device="cuda")
                 .to(bf16) for _ in range(4))


def check_packed_flash(torch, fa, rng, *, b, h, s, d, causal, hps,
                       views=False, q_seg=None, kv_seg=None):
    """The packed forward and fused backward at each hp in `hps` on one
    bf16 input, against the hp=1 kernels (o, lse, dk and dv bit for bit;
    dq within `PACKED_DQ_TOL` of its largest magnitude) and against the
    plain version (`attention_reference` and autograd through it: 1e-2
    of each output's largest magnitude, as `check_flash_attention` holds
    the hp=1 kernels).  Returns the errors by hp."""
    q, k, v, do = flash_inputs(torch, rng, b, h, s, d, views)
    sc = 1.0 / math.sqrt(d)
    o1, lse1 = fa.flash_fwd_cuda(q, k, v, sc, causal, q_seg, kv_seg)
    delta = torch.sum(do.float() * o1.float(), dim=-1)
    bwd_args = (q, k, v, do, lse1, delta, sc, causal)
    dq1, dk1, dv1 = fa.flash_bwd_cuda(*bwd_args, q_seg, kv_seg)
    dq1b, _, _ = fa.flash_bwd_cuda(*bwd_args, q_seg, kv_seg)
    qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))
    o_ref = fa.attention_reference(qr, kr, vr, causal=causal,
                                   softmax_scale=sc, q_segment_ids=q_seg,
                                   kv_segment_ids=kv_seg)
    o_ref.backward(do)
    torch.cuda.synchronize()
    what = f"packed flash ({b},{h},{s},{d}) causal={causal}"
    out = {"hp1_dq_run_to_run": (dq1.float() - dq1b.float()).abs().max()
           .item()}
    for hp in hps:
        o, lse = fa.flash_fwd_packed_cuda(q, k, v, sc, causal, hp, q_seg,
                                          kv_seg)
        dq, dk, dv = fa.flash_bwd_packed_cuda(*bwd_args, hp, q_seg, kv_seg)
        torch.cuda.synchronize()
        for name, got, one in (("o", o, o1), ("lse", lse, lse1),
                               ("dk", dk, dk1), ("dv", dv, dv1)):
            check(torch.equal(got, one),
                  f"{what} hp={hp}: {name} differs from the hp=1 kernel's")
        e = {"dq_vs_hp1": max_err(torch, f"{what} hp={hp} dq vs hp=1", dq,
                                  dq1, tol=PACKED_DQ_TOL)}
        for name, got, ref in (("o", o, o_ref), ("dq", dq, qr.grad),
                               ("dk", dk, kr.grad), ("dv", dv, vr.grad)):
            e[name] = max_err(torch, f"{what} hp={hp} {name} vs plain", got,
                              ref)
        out[hp] = e
    return out


def check_packed_routes(torch, fa, ln, ok, rng):
    """Two routes through the entry point and autograd that pair the
    packed forward with an unpacked backward, held against heads_per_step
    = 1 on the same inputs: hp=16 at MHA_SHAPE (hp * sk * d past the
    packed cap: the fused backward; o, dk, dv bit for bit, dq within
    `PACKED_DQ_TOL`) and hp=2 at LONG_SHAPE (sk * d past the fused cap:
    the split backward; o, dq, dk, dv bit for bit, the dq pass has no
    atomics).  The launch counters show each route."""
    out = {}
    for shape, hp, want in (
            (MHA_SHAPE, 16, {"flash_attention_fwd_packed": 1,
                             "flash_attention_bwd": 1}),
            (LONG_SHAPE, 2, {"flash_attention_fwd_packed": 1,
                             "flash_attention_bwd_dq": 1,
                             "flash_attention_bwd_dkv": 1})):
        q, k, v = (torch.randn(shape, generator=rng, device="cuda")
                   .to(torch.bfloat16).requires_grad_(True)
                   for _ in range(3))
        do = torch.randn(shape, generator=rng,
                         device="cuda").to(torch.bfloat16)
        check(fa.backward_route(shape[2], shape[3], hp) == (
            "fused" if hp == 16 else "split"), f"route at {shape} hp={hp}")

        def run(hp_):
            o = fa.flash_attention(q, k, v, causal=True,
                                   heads_per_step=hp_)
            return (o,) + torch.autograd.grad(o, (q, k, v), do)

        reset_kernel_counts(fa, ln, ok)
        got = run(hp)
        torch.cuda.synchronize()
        counts = {n: c for n, c in kernel_counts(fa, ln, ok).items() if c}
        check(counts == want, f"packed route at {shape} hp={hp}: launches "
              f"{counts}, want {want}")
        one = run(1)
        torch.cuda.synchronize()
        exact = ("o", "dk", "dv") + (("dq",) if hp == 2 else ())
        for name, g, w in zip(("o", "dq", "dk", "dv"), got, one):
            if name in exact:
                check(torch.equal(g, w), f"packed route at {shape} hp={hp}: "
                      f"{name} differs from hp=1")
        out[f"{shape} hp={hp}"] = {
            "launches": counts, "bitwise": list(exact),
            "dq_vs_hp1": 0.0 if hp == 2 else max_err(
                torch, f"packed route hp={hp} dq", got[1], one[1],
                tol=PACKED_DQ_TOL)}
        del q, k, v, do, got, one
        torch.cuda.empty_cache()
    return out


# Bodies for `_elementwise_call` (its section in ops/optimizer_kernels.py).
# The Triton bodies are written against the module global `tl`, which
# `triton_body` binds before `triton.jit`, at the first launch.
tl = None


def triton_body(fn):
    """A factory that returns `fn` jitted by Triton (made at launch)."""
    def factory():
        global tl
        import triton
        import triton.language

        tl = triton.language
        return triton.jit(fn)
    return factory


def _axpy(y, x, x2, x3, a, c1, c2, c3):
    # one body for both forms: the same fp32 operations in either
    return y + a * x


def _adam_plain(p, m, v, g, b1, c1, b2, c2):
    import torch

    m = b1 * m + c1 * g
    v = b2 * v + c2 * (g * g)
    return p - 1e-3 * (m / (torch.sqrt(v) + 1e-8)), m, v


def _adam_triton(p, m, v, g, b1, c1, b2, c2):
    m = b1 * m + c1 * g
    v = b2 * v + c2 * (g * g)
    return p - 1e-3 * tl.div_rn(m, tl.sqrt_rn(v) + 1e-8), m, v


def elementwise_kernels(ok):
    """The two bodies: axpy (y += 0.5 x; one output) and an Adam-shaped
    update (p, m, v from p, m, v, g with betas 0.9 / 0.999, lr 1e-3, eps
    1e-8; three outputs)."""
    axpy = ok.ElementwiseKernel(_axpy, triton_body(_axpy), (0.5,))
    adam = ok.ElementwiseKernel(_adam_plain, triton_body(_adam_triton),
                                (0.9, 1.0 - 0.9, 0.999, 1.0 - 0.999))
    return axpy, adam


def check_elementwise(torch, ok, rng):
    """`_elementwise_call` over EW_N fp32 elements (a ragged end) with
    both bodies, bit for bit with their plain versions (fp contraction
    off; IEEE square root and divide in both), the outputs updated in
    place.  Returns the max errors (0) and the launches."""
    axpy, adam = elementwise_kernels(ok)
    n0 = ok.elementwise_triton.launches

    def randn(scale=1.0):
        return torch.randn((EW_N,), generator=rng, device="cuda") * scale

    y, x = randn(), randn()
    want = ok._elementwise_reference(axpy, [y.clone(), x], 1)[0]
    got = ok._elementwise_call(axpy, [y, x], 1)[0]
    torch.cuda.synchronize()
    check(got is y and torch.equal(y, want),
          "elementwise axpy: kernel and plain version differ")
    del y, x, want, got
    p, m, g = randn(), randn(0.1), randn()
    v = randn(0.01).abs()
    want = ok._elementwise_reference(adam, [p.clone(), m.clone(), v.clone(),
                                            g], 3)
    got = ok._elementwise_call(adam, [p, m, v, g], 3)
    torch.cuda.synchronize()
    check(all(a is b for a, b in zip(got, (p, m, v))),
          "elementwise Adam: not in place")
    for name, a, b in zip("pmv", got, want):
        check(torch.equal(a, b), f"elementwise Adam {name}: kernel and "
              f"plain version differ")
    del p, m, v, g, want, got
    torch.cuda.empty_cache()
    return {"axpy": 0.0, "adam": 0.0,
            "launches": ok.elementwise_triton.launches - n0}


def mha_leg(torch, fa, ln, ok, rng, smi, warmup=1, iters=10):
    """bench.py's `_mha_latencies` (bench.py:229-256) on the card, tuned:
    `tune_flash` sweeps the H100 candidates at MHA_SHAPE (bf16, causal)
    and records the winner in this run's pinned cache; then the leg as
    bench.py times it — the gradient of flash_attention(q, k, v,
    causal=True).float().mean() with no knob, whose lookup must hit,
    `warmup` + `iters` iterations, ms an iteration — and the same for
    `attention_reference`, the leg's second number.  The winner's
    launchers are counted, and the leg's gradients are held against
    heads_per_step=1 (dk, dv bit for bit where the backward is fused or
    packed, dq within `PACKED_DQ_TOL`)."""
    from apex_tpu_torch.tune import search

    name, limit = (x.strip() for x in smi.split(",", 1))
    b, h, s, d = MHA_SHAPE
    t0 = time.perf_counter()
    best, results = search.tune_flash(
        b, h, s, d, dtype=torch.bfloat16, causal=True, iters=10, warmup=3,
        meta={"device": name, "power_limit": limit,
              "script": "chip_smoke.py (phase 11)"})
    sweep_s = time.perf_counter() - t0
    candidates_ms = {str(c["heads_per_step"]): 1e3 * t for c, t in results}
    log(f"MHA sweep {MHA_SHAPE} bf16 causal, fwd+bwd ms by heads_per_step: "
        f"{json.dumps(candidates_ms)}; winner {best}")
    q, k, v = (torch.randn(MHA_SHAPE, generator=rng, device="cuda")
               .to(torch.bfloat16).requires_grad_(True) for _ in range(3))

    def timed(fn, n):
        def grad():
            loss = fn(q, k, v).float().mean()
            return torch.autograd.grad(loss, (q, k, v))

        for _ in range(warmup):
            out = grad()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(n):
            out = grad()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t1) / n, out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts(fa, ln, ok)
    tune_stats(reset=True)
    fused_ms, grads = timed(
        lambda q_, k_, v_: fa.flash_attention(q_, k_, v_, causal=True), iters)
    peak = torch.cuda.max_memory_allocated()
    counts = {n_: c for n_, c in kernel_counts(fa, ln, ok).items() if c}
    tuned = tune_stats()
    n = warmup + iters
    hp = best["heads_per_step"]
    route = fa.backward_route(s, d, hp)
    want = {("flash_attention_fwd_packed" if hp > 1
             else "flash_attention_fwd"): n,
            {"packed": "flash_attention_bwd_packed",
             "fused": "flash_attention_bwd"}[route]: n}
    check(tuned["hits"] == n and tuned["misses"] == 0,
          f"MHA leg: the lookup did not hit on every call: {tuned}")
    check(counts == want, f"MHA leg launches {counts}, want {want}")
    one = torch.autograd.grad(fa.flash_attention(
        q, k, v, causal=True, heads_per_step=1).float().mean(), (q, k, v))
    torch.cuda.synchronize()
    check(torch.equal(grads[1], one[1]) and torch.equal(grads[2], one[2]),
          "MHA leg: dk, dv differ from heads_per_step=1")
    dq_err = max_err(torch, "MHA leg dq vs hp=1", grads[0], one[0],
                     tol=PACKED_DQ_TOL)
    del grads, one
    unfused_ms, _ = timed(
        lambda q_, k_, v_: fa.attention_reference(q_, k_, v_, causal=True),
        3)
    del q, k, v
    torch.cuda.empty_cache()
    return {"shape": list(MHA_SHAPE), "dtype": "bfloat16", "causal": True,
            "sweep_s": sweep_s, "candidates_fwd_bwd_ms": candidates_ms,
            "winner": best, "backward_route": route,
            "fused_ms": fused_ms, "unfused_ms": unfused_ms,
            "warmup": warmup, "iters": iters, "peak_mem_gib": peak / 2 ** 30,
            "tune": tuned, "launches": counts, "dq_vs_hp1_max_err": dq_err}


def slice8_phase(torch, fa, ln, ok, rng, smi, train, bert):
    """Phase 11 (module docstring): the tuned MHA leg, then phase 5's
    GPT-350M step and phase 6's BERT-Large step at attn_heads_per_step=2
    (every flash launch a packed one, no host sync, the loss falls, and
    the first step's loss bit for bit the hp=1 phase's: the packed
    forward is bit-identical).  `train`, `bert`: phases 5 and 6."""
    t0 = time.perf_counter()
    mha = mha_leg(torch, fa, ln, ok, rng, smi)
    log("MHA leg " + json.dumps(mha))
    gpt, gpt_vs_plain = flash_gpt_phase(torch, fa, ln, ok, "GPT hp=2",
                                        "packed", warmup=2, steps=3,
                                        heads_per_step=2)
    check(gpt["losses"][0] == train["losses"][0],
          f"GPT hp=2: first loss {gpt['losses'][0]!r} is not phase 5's "
          f"{train['losses'][0]!r}")
    log("GPT hp=2 " + json.dumps(gpt))
    log("GPT tokens/s, peak GiB: hp=2 "
        f"{gpt['tokens_per_s']:.1f}, {gpt['peak_mem_gib']:.3f}; phase 5 "
        f"{train['tokens_per_s']:.1f}, {train['peak_mem_gib']:.3f}")
    torch.cuda.empty_cache()
    bert2, bert2_vs_plain = bert_phase(torch, fa, ln, ok, steps=3,
                                       heads_per_step=2)
    check(bert2["losses"][0] == bert["losses"][0],
          f"BERT hp=2: first loss {bert2['losses'][0]!r} is not phase 6's "
          f"{bert['losses'][0]!r}")
    log("bert hp=2 " + json.dumps(bert2))
    log("BERT seq/s, peak GiB: hp=2 "
        f"{bert2['seq_per_s']:.2f}, {bert2['peak_mem_gib']:.3f}; phase 6 "
        f"{bert['seq_per_s']:.2f}, {bert['peak_mem_gib']:.3f}")
    torch.cuda.empty_cache()
    log(f"phase 11 {time.perf_counter() - t0:.1f}s")
    return {"mha": mha, "gpt": gpt, "bert": bert2}, {
        "gpt": gpt_vs_plain, "bert": bert2_vs_plain}


def table_slice8_kernels(torch, fa, ok, rng, errs, slice8):
    """Phase 12 rows of this slice's kernels.  The packed pair at GPT's
    (12, 16, 1024, 64) causal, on the step's views (the rows' `ms`), with
    the hp=1 kernel and the packed launcher at hp 1, 2 and 4, and at
    MHA_SHAPE at hp 1, 2, 4, 8 and 16; bounds as the hp=1 rows count them
    (the score pairs at or below the diagonal: 4 d flop a pair forward,
    10 d backward, bf16 tensor cores); library: SDPA on the same call.
    Launches: phase 11's GPT and BERT steps and the MHA leg.  The
    elementwise launcher: axpy over EW_N fp32 elements against its plain
    version and `Tensor.add_(x, alpha=0.5)`, bound by its 12 bytes an
    element; it has no main path (no caller in either package)."""
    import torch.nn.functional as F

    def pairs(b, h, s):
        return b * h * s * (s + 1) // 2

    mha, gpt, bert = slice8["mha"], slice8["gpt"], slice8["bert"]
    shapes = {}
    for label, shape, hps, views in (
            ("gpt", (12, 16, 1024, 64), (1, 2, 4), True),
            ("mha", MHA_SHAPE, (1, 2, 4, 8, 16), False)):
        b, h, s, d = shape
        q, k, v, do = flash_inputs(torch, rng, b, h, s, d, views)
        sc = 1.0 / math.sqrt(d)
        o, lse = fa.flash_fwd_cuda(q, k, v, sc, True)
        delta = torch.sum(do.float() * o.float(), dim=-1)
        t = {"fwd_unpacked": time_ms(torch, lambda: fa.flash_fwd_cuda(
                 q, k, v, sc, True)),
             "bwd_unpacked": time_ms(torch, lambda: fa.flash_bwd_cuda(
                 q, k, v, do, lse, delta, sc, True))}
        for hp in hps:
            t[f"fwd_hp{hp}"] = time_ms(torch, lambda: fa.flash_fwd_packed_cuda(
                q, k, v, sc, True, hp))
            t[f"bwd_hp{hp}"] = time_ms(torch, lambda: fa.flash_bwd_packed_cuda(
                q, k, v, do, lse, delta, sc, True, hp))
        t["fwd_sdpa"] = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=sc))
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                             scale=sc)
        t["bwd_sdpa"] = time_ms(torch, lambda: torch.autograd.grad(
            out, (qg, kg, vg), do, retain_graph=True))
        del out
        if label == "gpt":
            t["fwd_plain"] = time_ms(torch, lambda: fa.attention_reference(
                q, k, v, causal=True, softmax_scale=sc), n=10)
            out = fa.attention_reference(qg, kg, vg, causal=True,
                                         softmax_scale=sc)
            t["bwd_plain"] = time_ms(torch, lambda: torch.autograd.grad(
                out, (qg, kg, vg), do, retain_graph=True), n=10)
            del out
        io = b * h * s * d * 2
        t["fwd_bound"] = 1e3 * max((4 * io + b * h * s * 4) / HBM_BYTES_PER_S,
                                   4 * pairs(b, h, s) * d / BF16_FLOPS)
        t["bwd_bound"] = 1e3 * max(
            (7 * io + 2 * b * h * s * 4) / HBM_BYTES_PER_S,
            10 * pairs(b, h, s) * d / BF16_FLOPS)
        shapes[label] = t
        del q, k, v, do, o, lse, delta, qg, kg, vg
        torch.cuda.empty_cache()
    log("packed flash times " + json.dumps(shapes))
    g = shapes["gpt"]
    b, h, s, d = 12, 16, 1024, 64
    io = b * h * s * d * 2
    rows = []
    for key, name, replaces, bytes_, ops in (
            ("fwd", "flash_attention_fwd_packed",
             "apex_tpu/ops/flash_attention.py:385",
             4 * io + b * h * s * 4, 4 * pairs(b, h, s) * d),
            ("bwd", "flash_attention_bwd_packed",
             "apex_tpu/ops/flash_attention.py:643",
             7 * io + 2 * b * h * s * 4, 10 * pairs(b, h, s) * d)):
        counter = f"flash_attention_{key}_packed"
        launches = (gpt["launches"][counter] + bert["launches"][counter]
                    + mha["launches"].get(counter, 0))
        row = table_row(
            name, launches, gpt["launches_per_step"][counter],
            errs[counter], "cuda", "apex_tpu_torch/csrc/flash_attention.cu",
            replaces, g[f"{key}_hp2"], g[f"{key}_plain"], g[f"{key}_sdpa"],
            "scaled_dot_product_attention(is_causal=True)"
            + (" backward (autograd)" if key == "bwd" else ""),
            bytes_, ops, "q,k,v (12,16,1024,64) bf16 views of qkv (1024,12,"
            "3072), causal, heads_per_step=2")
        row.update({
            "launches_gpt_hp2": gpt["launches"][counter],
            "launches_bert_hp2": bert["launches"][counter],
            "launches_mha_leg": mha["launches"].get(counter, 0),
            "ms_gpt_by_hp": {k_[len(key) + 3:]: v_ for k_, v_ in g.items()
                             if k_.startswith(f"{key}_hp")},
            "ms_gpt_unpacked_kernel": g[f"{key}_unpacked"],
            "ms_mha_by_hp": {k_[len(key) + 3:]: v_
                             for k_, v_ in shapes["mha"].items()
                             if k_.startswith(f"{key}_hp")},
            "ms_mha_unpacked_kernel": shapes["mha"][f"{key}_unpacked"],
            "bound_ms_mha": shapes["mha"][f"{key}_bound"],
            "library_ms_mha": shapes["mha"][f"{key}_sdpa"]})
        rows.append(row)
    # the elementwise launcher: axpy, in place
    axpy, adam = elementwise_kernels(ok)
    y, x = (torch.randn((EW_N,), generator=rng, device="cuda")
            for _ in range(2))
    ew_ms = time_ms(torch, lambda: ok.elementwise_triton(axpy, [y, x], 1),
                    n=20)
    ew_plain = time_ms(torch, lambda: ok._elementwise_reference(
        axpy, [y, x], 1), n=10)
    ew_lib = time_ms(torch, lambda: y.add_(x, alpha=0.5), n=20)
    m, g_ = (torch.randn((EW_N,), generator=rng, device="cuda")
             for _ in range(2))
    vv = torch.rand((EW_N,), generator=rng, device="cuda")
    adam_ms = time_ms(torch, lambda: ok.elementwise_triton(
        adam, [y, m, vv, g_], 3), n=10)
    row = table_row(
        "elementwise", 0, 0, errs["elementwise"], "triton",
        "apex_tpu_torch/ops/optimizer_kernels.py",
        "apex_tpu/ops/optimizer_kernels.py:73", ew_ms, ew_plain, ew_lib,
        "Tensor.add_(x, alpha=0.5)", 12 * EW_N, 2 * EW_N,
        f"axpy y += 0.5 x over ({EW_N},) fp32, in place")
    row.update({"launches_in_checks": errs["elementwise_launches"],
                "main_path": "none (no caller in apex_tpu or the port)",
                "ms_adam_shaped": adam_ms,
                "bound_ms_adam_shaped": 1e3 * 28 * EW_N / HBM_BYTES_PER_S})
    rows.append(row)
    del y, x, m, g_, vv
    torch.cuda.empty_cache()
    return rows


def decode_times(torch, fd, case, flush):
    """Flash-decode on `case`: the kernel with a cold L2 (`flush` before
    each launch) and a warm one, its plain version, SDPA over the cache
    gathered densely beforehand (the gather not timed) with the same
    position mask, the bound (each visible K/V row read once, q read and
    out written, the table and lengths; q.k and p.v at the fp32 rate,
    far under the bytes) and the plan."""
    q, k, v, tbl, lens = case
    sc = 1.0 / math.sqrt(q.shape[3])
    ms = time_ms(torch, lambda: fd.flash_decode_cuda(q, k, v, tbl, lens, sc),
                 flush=flush)
    plan = list(fd.flash_decode_cuda.last_plan)
    warm = time_ms(torch, lambda: fd.flash_decode_cuda(q, k, v, tbl, lens,
                                                       sc))
    plain = time_ms(torch, lambda: fd.paged_attention_reference(
        q, k, v, tbl, lens, softmax_scale=sc), flush=flush, n=20)
    n_slots, hkv, d = q.shape[0], k.shape[0], q.shape[3]
    kd = k[:, tbl.long()].permute(1, 0, 2, 3, 4).reshape(n_slots, hkv, -1, d)
    vd = v[:, tbl.long()].permute(1, 0, 2, 3, 4).reshape(n_slots, hkv, -1, d)
    qd = q.permute(0, 2, 1, 3)
    mask = (torch.arange(kd.shape[2], device="cuda")[None, None, None, :]
            < lens[:, None, None, None])
    lib = time_ms(torch, lambda: torch.nn.functional
                  .scaled_dot_product_attention(qd, kd, vd, attn_mask=mask),
                  flush=flush)
    vis_keys = sum(min(int(n), tbl.shape[1] * k.shape[2])
                   for n in lens.tolist())
    el = q.element_size()
    bytes_ = (2 * vis_keys * hkv * d * el           # K and V rows read
              + 2 * q.numel() * el                   # q in, out
              + tbl.numel() * 4 + lens.numel() * 4)
    ops = 4 * vis_keys * hkv * d                     # q.k and p.v
    bound = 1e3 * max(bytes_ / HBM_BYTES_PER_S, ops / FP32_FLOPS)
    return {"ms": ms, "warm_l2_ms": warm, "plain_ms": plain,
            "library_ms": lib, "bound_ms": bound, "plan": plan,
            "shape": f"q {tuple(q.shape)} {q.dtype}, pages "
                     f"{tuple(k.shape)}, table {tuple(tbl.shape)}"}


# ----------------------------------------------- phase 12: slice 14 ----
#
# Dropout inside the six flash kernels (phase 2's checks below), then the
# GPT-350M step with dropout and with remat, and bench.py's two remaining
# single-device legs (`adam_1b`, `gpt1p3b`).

DROP_SEED = 0x5EED1                # the phase-2 cases' flash seed
DROP_RATES = (0.1, 0.5)


def check_flash_dropout(torch, fa, rng, *, b, h, s, d, causal, hps=(),
                        views=False, q_seg=None, kv_seg=None, q_off=0,
                        split=False, rates=DROP_RATES):
    """The flash kernels with in-kernel dropout at each rate in `rates`,
    on one bf16 input and the seed triple (DROP_SEED, q_off, 0): the
    forward against `flash_fwd_reference` (o within 1e-2 of its largest
    magnitude, the rate-0 tolerance of `check_flash_attention`; lse bit for
    bit the rate-0 kernel's, since dropout leaves the softmax sum alone),
    the fused backward against `flash_bwd_dq_reference` /
    `flash_bwd_dkv_reference` on the kernel's lse (1e-2), each run twice
    (o, lse, dk, dv the same bits; dq within the tolerance); at each hp in
    `hps` the packed pair bit for bit the hp=1 kernels' (o, lse, dk, dv;
    dq within `PACKED_DQ_TOL`); with `split` the dq pass (twice, the same
    bits, against its plain version) and the dk/dv pass (bit for bit the
    fused kernel's).  Returns the errors by rate."""
    q, k, v, do = flash_inputs(torch, rng, b, h, s, d, views)
    sc = 1.0 / math.sqrt(d)
    seg = (q_seg, kv_seg)
    o0, lse0 = fa.flash_fwd_cuda(q, k, v, sc, causal, *seg)
    what = (f"flash dropout ({b},{h},{s},{d}) causal={causal} "
            f"ids={q_seg is not None} q_off={q_off}")
    out = {}
    for rate in rates:
        kw = dict(dropout_rate=rate, seed=(DROP_SEED, q_off, 0))
        o, lse = fa.flash_fwd_cuda(q, k, v, sc, causal, *seg, **kw)
        o2, lse2 = fa.flash_fwd_cuda(q, k, v, sc, causal, *seg, **kw)
        delta = torch.sum(do.float() * o.float(), dim=-1)
        bargs = (q, k, v, do, lse, delta, sc, causal, *seg)
        dq, dk, dv = fa.flash_bwd_cuda(*bargs, **kw)
        dq2, dk2, dv2 = fa.flash_bwd_cuda(*bargs, **kw)
        o_ref, _ = fa.flash_fwd_reference(q, k, v, sc, causal, *seg, **kw)
        dq_ref = fa.flash_bwd_dq_reference(*bargs, **kw)
        dk_ref, dv_ref = fa.flash_bwd_dkv_reference(*bargs, **kw)
        torch.cuda.synchronize()
        case = f"{what} rate={rate}"
        check(torch.equal(o, o2) and torch.equal(lse, lse2),
              f"{case}: o or lse differ from run to run")
        check(torch.equal(lse, lse0), f"{case}: lse differs from rate 0's")
        check(not torch.equal(o, o0), f"{case}: o is rate 0's")
        check(torch.equal(dk, dk2) and torch.equal(dv, dv2),
              f"{case}: dk, dv differ from run to run")
        e = {name: max_err(torch, f"{case} {name}", got, ref)
             for name, got, ref in (("o", o, o_ref), ("dq", dq, dq_ref),
                                    ("dq_second_run", dq2, dq_ref),
                                    ("dk", dk, dk_ref), ("dv", dv, dv_ref))}
        for hp in hps:
            po, plse = fa.flash_fwd_packed_cuda(q, k, v, sc, causal, hp,
                                                *seg, **kw)
            pdq, pdk, pdv = fa.flash_bwd_packed_cuda(*bargs[:8], hp, *seg,
                                                     **kw)
            torch.cuda.synchronize()
            for name, got, one in (("o", po, o), ("lse", plse, lse),
                                   ("dk", pdk, dk), ("dv", pdv, dv)):
                check(torch.equal(got, one), f"{case} hp={hp}: {name} "
                      "differs from the hp=1 kernel's")
            e[f"dq_hp{hp}_vs_hp1"] = max_err(
                torch, f"{case} hp={hp} dq vs hp=1", pdq, dq,
                tol=PACKED_DQ_TOL)
        if split:
            sdq = fa.flash_bwd_dq_cuda(*bargs, **kw)
            sdq2 = fa.flash_bwd_dq_cuda(*bargs, **kw)
            sdk, sdv = fa.flash_bwd_dkv_cuda(*bargs, **kw)
            torch.cuda.synchronize()
            check(torch.equal(sdq, sdq2), f"{case}: the dq pass differs "
                  "from run to run")
            check(torch.equal(sdk, dk) and torch.equal(sdv, dv),
                  f"{case}: the dk/dv pass differs from the fused kernel")
            e["dq_pass"] = max_err(torch, f"{case} dq pass", sdq, dq_ref)
        out[rate] = e
        del o, o2, dq, dq2, dk, dk2, dv, dv2, o_ref, dq_ref, dk_ref, dv_ref
    torch.cuda.empty_cache()
    return out


def check_dropout_mask(torch, fa, *, b, h, d, rate, q_off, k_off,
                       seed=DROP_SEED):
    """Each kernel's keep mask read back on the card against
    `dropout_keep_dense`, bit for bit, at sq = sk = d (non-causal, bf16):
    with q = 0 every weight is 1/sk.  The forward (and the packed one at
    hp 2) with v = I: o[q, j] = keep[q, j] / (sk (1 - rate)), 0 where
    dropped.  The fused backward and the dk/dv pass with v = I and do =
    I: dv[k, q] = p·keep[q, k] / (1 - rate).  The dq pass (and the fused
    kernel's dq) with k = I, v = do = 1 and delta = 0: dq[q, j] = scale ·
    p · d · keep[q, j] / (1 - rate).  Returns the keep share."""
    dev, bf16 = "cuda", torch.bfloat16
    s = d
    sc = 1.0 / math.sqrt(d)
    want = fa.dropout_keep_dense(seed, b, h, s, s, rate, q_off, k_off,
                                 device=dev)
    kw = dict(dropout_rate=rate, seed=(seed, q_off, k_off))
    eye = torch.eye(s, device=dev).to(bf16).expand(b, h, s, s).contiguous()
    zero = torch.zeros((b, h, s, d), device=dev, dtype=bf16)
    ones = torch.ones((b, h, s, d), device=dev, dtype=bf16)
    o, lse = fa.flash_fwd_cuda(zero, eye, eye, sc, False, **kw)
    po, _ = fa.flash_fwd_packed_cuda(zero, eye, eye, sc, False, 2, **kw)
    delta = torch.zeros((b, h, s), device=dev)
    bargs = (zero, eye, eye, eye, lse, delta, sc, False)
    _, _, dv = fa.flash_bwd_cuda(*bargs, **kw)
    _, pdv = fa.flash_bwd_dkv_cuda(*bargs, **kw)
    qargs = (zero, eye, ones, ones, lse, delta, sc, False)
    dq = fa.flash_bwd_dq_cuda(*qargs, **kw)
    fdq, _, _ = fa.flash_bwd_cuda(*qargs, **kw)
    torch.cuda.synchronize()
    what = f"dropout mask ({b},{h},{s},{d}) rate={rate} offs=({q_off},{k_off})"
    for name, got in (("forward", o != 0), ("packed forward", po != 0),
                      ("fused backward dv", (dv != 0).transpose(-1, -2)),
                      ("dk/dv pass dv", (pdv != 0).transpose(-1, -2)),
                      ("dq pass", dq != 0), ("fused backward dq", fdq != 0)):
        check(torch.equal(got, want), f"{what}: the {name} kernel's mask "
              f"differs from dropout_keep_dense at "
              f"{int((got != want).sum())} of {want.numel()} scores")
    return want.float().mean().item()


def remat_grads_check(torch, fa, ln, ok):
    """One GPT-350M step's loss and gradients at full width, 2 layers,
    batch 2 x seq 1024, dropout 0.1 with one fixed key, without remat and
    with remat (policy None), through the kernels.  On the CPU the two
    are bit for bit (tests/test_torch_gpt_remat.py); on the card the
    fused backward sums dq by reduce-adds in an order that changes from
    run to run, so the check is the loss within 1e-3 and each gradient
    within 1e-2 relative L2, and whether the bits are the same is
    printed."""
    from apex_tpu_torch.models import gpt as gpt_mod

    out = {}
    grads = {}
    gen = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randint(0, 50304, (2, 1024), generator=gen,
                           device="cuda", dtype=torch.int32)
    labels = torch.roll(tokens, -1, dims=1)
    for remat in (False, True):
        model = gpt_mod.gpt_350m(num_layers=2, dropout=0.1,
                                 dtype=torch.bfloat16,
                                 logits_dtype=torch.bfloat16,
                                 use_flash_attention=True, remat=remat)
        params = model.init(seed=0)
        leaves = [t.requires_grad_(True) for t in
                  torch.utils._pytree.tree_leaves(params)]
        loss = model.loss(params, tokens, labels,
                          key=torch.Generator().manual_seed(11))
        grads[remat] = (loss.detach(), torch.autograd.grad(loss, leaves))
    torch.cuda.synchronize()
    (l0, g0), (l1, g1) = grads[False], grads[True]
    rel = [((a.float() - b.float()).norm() / b.float().norm()).item()
           for a, b in zip(g1, g0) if b.float().norm() > 0]
    out = {"loss": float(l0), "loss_remat": float(l1),
           "bits_same": bool(torch.equal(l0, l1) and all(
               torch.equal(a, b) for a, b in zip(g0, g1))),
           "grad_rel_l2_max": max(rel)}
    check(abs(out["loss"] - out["loss_remat"]) <= 1e-3 * abs(out["loss"]),
          f"remat step loss differs: {out}")
    check(out["grad_rel_l2_max"] <= 1e-2, f"remat step grads differ: {out}")
    return out


def adam_1b_leg(torch, ok, warmup=3, iters=20):
    """bench.py's `_adam_1b_step_ms` (bench.py:1021-1049): `adam_flat` over
    10^9 fp32 params (FLAT_TILE-padded) with bf16 grads of 1e-3, lr 1e-3,
    step 10, weight decay 0.01, p/m/v updated in place (the JAX leg
    donates them), `warmup` + `iters` steps, ms a step on the host's clock
    (synchronised at the window's ends, as the bench reads it) and on the
    card's (CUDA events); bound: 26 bytes a param (p, m, v read and
    written in fp32, g read in bf16) over the card's memory rate."""
    n = -(-10 ** 9 // ok.FLAT_TILE) * ok.FLAT_TILE
    p, m, v = (torch.zeros(n, device="cuda") for _ in range(3))
    g = torch.full((n,), 1e-3, device="cuda", dtype=torch.bfloat16)
    ok.adam_flat_triton.launches = 0

    def step():
        ok.adam_flat(p, m, v, g, lr=1e-3, step=10, weight_decay=0.01)

    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0) / iters
    launches = ok.adam_flat_triton.launches
    check(launches == warmup + iters, f"adam_1b: {launches} launches")
    check(bool(torch.isfinite(p[:1000]).all()) and float(p[0]) != 0.0,
          "adam_1b: p did not move or is not finite")
    dev_ms = time_ms(torch, step, n=10, warm=1)
    out = {"params": n, "step_ms": host_ms, "device_ms": dev_ms,
           "bound_ms": 1e3 * 26 * n / HBM_BYTES_PER_S, "launches": launches}
    del p, m, v, g
    torch.cuda.empty_cache()
    return out


def gpt1p3b_leg(torch, fa, ln, ok, warmup=3, steps=20):
    """bench.py's `_gpt1p3b_tokens_per_sec` (bench.py:259-280) on the
    card: `gpt_1p3b()` (h2048, L24, 32 heads of 64) at batch 7 x seq 512,
    vocab 50304, bf16, bf16 logits, flash attention, no remat,
    FusedAdam(lr=1e-4, master bf16), seed-0 weights, one seeded batch;
    `warmup` + `steps` steps: the loss finite and falling, 24 flash
    forwards and backwards, 49 LayerNorm forwards and backwards and one
    Adam a step; tokens/s, peak memory and one profiled step."""
    from apex_tpu_torch.models import gpt as gpt_mod
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.transformer.training import (
        init_sharded_optimizer, make_tp_dp_train_step)

    batch, seq = 7, 512
    bf16 = torch.bfloat16
    model = gpt_mod.gpt_1p3b(vocab_size=50304, seq_len=seq, dropout=0.0,
                             dtype=bf16, logits_dtype=bf16,
                             use_flash_attention=True)
    opt = FusedAdam(lr=1e-4, master_dtype=bf16)
    state = init_sharded_optimizer(opt, model, model.init(seed=0))
    step = make_tp_dp_train_step(model, opt)
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, 50304, (batch, seq), generator=gen,
                           device="cuda", dtype=torch.int32)
    labels = torch.roll(tokens, -1, dims=1)
    per_step = {"flash_attention_fwd": 24, "flash_attention_bwd": 24,
                "layer_norm_fwd": 49, "layer_norm_bwd": 49, "adam": 1}
    state, result = train_loop(torch, fa, ln, ok, "gpt1p3b", step, state,
                               (tokens, labels), per_step, warmup, steps)
    state, syncs = step_without_sync(torch, step, state, tokens, labels)
    state, prof = profile_step(torch, step, state, (tokens, labels), {
        "flash_attention_fwd": lambda k: "flash_fwd_kernel" in k,
        "flash_attention_bwd": lambda k: "flash_bwd_kernel" in k,
        "adam": lambda k: k == "_adam_kernel"})
    out = dict(result, config="GPT-1.3B bf16, batch 7 x seq 512, vocab "
               "50304, bf16 logits, flash, no remat, FusedAdam(lr=1e-4, "
               "master bf16)", params=sum(opt.spec.sizes),
               tokens_per_s=batch * seq * steps / result["window_s"],
               host_syncs_per_step=len(syncs), profile=prof)
    del state, opt, step
    torch.cuda.empty_cache()
    return out


def slice14_phase(torch, fa, ln, ok, train):
    """Phase 12 (module docstring): GPT-350M at phase 5's configuration
    with dropout 0.1 and a fresh step key each step (2 + 3 steps), then
    with remat under None, "dots" and "names:attn_ctx,ffn1" (1 + 2 steps
    each), the remat-vs-not gradient check, and bench.py's `adam_1b` and
    `gpt1p3b` legs.  `train`: phase 5's line, for the comparison."""
    t0 = time.perf_counter()
    out = {}
    drop, drop_vs_plain = flash_gpt_phase(
        torch, fa, ln, ok, "GPT dropout", "fused", warmup=2, steps=3,
        dropout=0.1)
    out["dropout"] = drop
    out["dropout_vs_plain"] = drop_vs_plain
    log(f"GPT dropout 0.1: tokens/s, peak GiB, device ms "
        f"{drop['tokens_per_s']:.1f}, {drop['peak_mem_gib']:.3f}, "
        f"{drop['profile']['device_ms']:.2f}; phase 5 "
        f"{train['tokens_per_s']:.1f}, {train['peak_mem_gib']:.3f}, "
        f"{train['profile']['device_ms']:.2f}; flash kernels ms "
        f"{json.dumps(drop['profile']['kernels_ms'])} (phase 5 "
        f"{json.dumps(train['profile']['kernels_ms'])})")
    torch.cuda.empty_cache()
    out["remat"] = {}
    for policy in (None, "dots", "names:attn_ctx,ffn1"):
        r, _ = flash_gpt_phase(
            torch, fa, ln, ok, f"GPT dropout remat={policy}", "fused",
            warmup=1, steps=2, dropout=0.1, remat_policy=policy,
            compare=False)
        out["remat"][str(policy)] = r
        log(f"GPT dropout remat {policy}: tokens/s, peak GiB, device ms "
            f"{r['tokens_per_s']:.1f}, {r['peak_mem_gib']:.3f}, "
            f"{r['profile']['device_ms']:.2f}")
        torch.cuda.empty_cache()
    out["remat_grads"] = remat_grads_check(torch, fa, ln, ok)
    log("GPT remat vs no remat, one step at 2 layers "
        + json.dumps(out["remat_grads"]))
    torch.cuda.empty_cache()
    out["adam_1b"] = adam_1b_leg(torch, ok)
    log("adam_1b " + json.dumps(out["adam_1b"]))
    out["gpt1p3b"] = gpt1p3b_leg(torch, fa, ln, ok)
    log("gpt1p3b " + json.dumps(out["gpt1p3b"]))
    log(f"phase 12 {time.perf_counter() - t0:.1f}s")
    return out


def table_dropout_kernels(torch, fa, rng, errs, slice14):
    """Phase 12 rows of the six flash kernels' dropout instantiations at
    rate 0.1, beside their rate-0 times in the same call: the forward, the
    fused backward and (hp=2) the packed pair at GPT's causal (12, 16,
    1024, 64) on the step's views, the split pair at GPT-350M's seq 8192
    (1, 16, 8192, 64).  Bounds as the rate-0 rows count them (bytes once,
    the causal pairs' tensor-core flop; the hash's integer operations are
    not counted).  Plain: `flash_fwd_reference` and the backward's plain
    versions with the same mask.  Library: SDPA with dropout_p=0.1
    (forward; the backward by autograd: dq, dk and dv).  Launches: phase
    12's dropout step (the packed and split instantiations run on no main
    path: phase 2 holds them)."""
    import torch.nn.functional as F

    from apex_tpu_torch.ops.fused_dense import qkv_split_heads

    bf16 = torch.bfloat16
    drop = slice14["dropout"]
    rows = []
    kw = dict(dropout_rate=0.1, seed=(DROP_SEED, 0, 0))

    def pairs(bb, hh, ss):
        return bb * hh * ss * (ss + 1) // 2           # causal score pairs

    def row(name, replaces, ms, ms0, plain, lib, bytes_, ops, shape):
        counter = name
        r = table_row(name, drop["launches"].get(counter, 0),
                      drop["launches_per_step"].get(counter, 0), errs[name],
                      "cuda", "apex_tpu_torch/csrc/flash_attention.cu",
                      replaces, ms, plain, lib,
                      "scaled_dot_product_attention(dropout_p=0.1, "
                      "is_causal=True)" + (" backward (autograd)"
                                           if "bwd" in name else ""),
                      bytes_, ops, shape)
        r.update(rate=0.1, rate0_ms=ms0)
        rows.append(r)

    b, h, s, d = 12, 16, 1024, 64
    sc = 1.0 / math.sqrt(d)
    qkv = torch.randn((s, b, 3 * h * d), generator=rng, device="cuda").to(bf16)
    q, k, v = qkv_split_heads(qkv, h, d)
    do = torch.randn((s, b, h, d), generator=rng,
                     device="cuda").to(bf16).permute(1, 2, 0, 3)
    o, lse = fa.flash_fwd_cuda(q, k, v, sc, True, **kw)
    delta = torch.sum(do.float() * o.float(), dim=-1)
    bargs = (q, k, v, do, lse, delta, sc, True)
    io, p = b * h * s * d * 2, pairs(b, h, s)
    shape = "q,k,v (12,16,1024,64) bf16 views of qkv (1024,12,3072), causal"
    t = {}
    for name, fn in (
            ("fwd", lambda: fa.flash_fwd_cuda(q, k, v, sc, True, **kw)),
            ("fwd0", lambda: fa.flash_fwd_cuda(q, k, v, sc, True)),
            ("bwd", lambda: fa.flash_bwd_cuda(*bargs, **kw)),
            ("bwd0", lambda: fa.flash_bwd_cuda(*bargs)),
            ("pfwd", lambda: fa.flash_fwd_packed_cuda(q, k, v, sc, True, 2,
                                                      **kw)),
            ("pfwd0", lambda: fa.flash_fwd_packed_cuda(q, k, v, sc, True, 2)),
            ("pbwd", lambda: fa.flash_bwd_packed_cuda(*bargs, 2, **kw)),
            ("pbwd0", lambda: fa.flash_bwd_packed_cuda(*bargs, 2))):
        t[name] = time_ms(torch, fn)
    plain_fwd = time_ms(torch, lambda: fa.flash_fwd_reference(
        q, k, v, sc, True, **kw), n=5, warm=1)
    plain_bwd = time_ms(torch, lambda: (
        fa.flash_bwd_dq_reference(*bargs, **kw),
        fa.flash_bwd_dkv_reference(*bargs, **kw)), n=5, warm=1)
    lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, dropout_p=0.1, is_causal=True, scale=sc))
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg, dropout_p=0.1,
                                         is_causal=True, scale=sc)
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
        out, (qg, kg, vg), do, retain_graph=True))
    del out, qg, kg, vg
    for name, replaces, key, plain, lib, bytes_, ops in (
            ("flash_attention_fwd_dropout",
             "apex_tpu/ops/flash_attention.py:289", "fwd", plain_fwd,
             lib_fwd, 4 * io + b * h * s * 4, 4 * p * d),
            ("flash_attention_bwd_dropout",
             "apex_tpu/ops/flash_attention.py:564", "bwd", plain_bwd,
             lib_bwd, 7 * io + 2 * b * h * s * 4, 10 * p * d),
            ("flash_attention_fwd_packed_dropout",
             "apex_tpu/ops/flash_attention.py:385", "pfwd", plain_fwd,
             lib_fwd, 4 * io + b * h * s * 4, 4 * p * d),
            ("flash_attention_bwd_packed_dropout",
             "apex_tpu/ops/flash_attention.py:643", "pbwd", plain_bwd,
             lib_bwd, 7 * io + 2 * b * h * s * 4, 10 * p * d)):
        row(name, replaces, t[key], t[key + "0"], plain, lib, bytes_, ops,
            shape + ("" if "fwd" in name else ", do a permuted view")
            + (", hp=2" if "packed" in name else ""))
    del qkv, q, k, v, do, o, lse, delta, bargs
    torch.cuda.empty_cache()
    # the split pair at GPT-350M's seq 8192
    gshape = (1, 16, 8192, 64)
    b, h, s, d = gshape
    q, k, v, do = (torch.randn(gshape, generator=rng, device="cuda")
                   .to(bf16) for _ in range(4))
    o, lse = fa.flash_fwd_cuda(q, k, v, sc, True, **kw)
    delta = torch.sum(do.float() * o.float(), dim=-1)
    bargs = (q, k, v, do, lse, delta, sc, True)
    t = {"dq": time_ms(torch, lambda: fa.flash_bwd_dq_cuda(*bargs, **kw)),
         "dq0": time_ms(torch, lambda: fa.flash_bwd_dq_cuda(*bargs)),
         "dkv": time_ms(torch, lambda: fa.flash_bwd_dkv_cuda(*bargs, **kw)),
         "dkv0": time_ms(torch, lambda: fa.flash_bwd_dkv_cuda(*bargs))}
    plain = {"dq": time_ms(torch, lambda: fa.flash_bwd_dq_reference(
        *bargs, **kw), n=3, warm=1),
             "dkv": time_ms(torch, lambda: fa.flash_bwd_dkv_reference(
                 *bargs, **kw), n=3, warm=1)}
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg, dropout_p=0.1,
                                         is_causal=True, scale=sc)
    lib = time_ms(torch, lambda: torch.autograd.grad(
        out, (qg, kg, vg), do, retain_graph=True))
    del out, qg, kg, vg
    io, p = b * h * s * d * 2, pairs(b, h, s)
    for name, replaces, key, products, outs in (
            ("flash_attention_bwd_dq_dropout",
             "apex_tpu/ops/flash_attention.py:447", "dq", 3, 1),
            ("flash_attention_bwd_dkv_dropout",
             "apex_tpu/ops/flash_attention.py:497", "dkv", 4, 2)):
        row(name, replaces, t[key], t[key + "0"], plain[key], lib,
            (4 + outs) * io + 2 * b * h * s * 4, 2 * products * d * p,
            f"q, k, v, do {gshape} bf16, causal; lse, delta fp32")
    del q, k, v, do, o, lse, delta, bargs
    torch.cuda.empty_cache()
    return rows


def table_row(name, launches, per_step, err, route, source, replaces, ms,
              plain_ms, library_ms, library, bytes_, ops, shape, peak=None):
    """One row of the kernel table.  The bound is the larger of the bytes
    at the card's memory rate and the operations at its peak for their
    type (`peak`; by default bf16 tensor cores for flash attention, fp32
    otherwise)."""
    by_bytes = bytes_ / HBM_BYTES_PER_S
    if peak is None:
        peak = BF16_FLOPS if name.startswith("flash") else FP32_FLOPS
    by_ops = ops / peak
    row = {"name": name, "route": route, "source": source,
           "replaces": replaces, "launches": launches,
           "launches_per_train_step": per_step, "max_abs_err": err,
           "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
           "bound_ms": 1e3 * max(by_bytes, by_ops),
           "bound_by": "bytes" if by_bytes >= by_ops else "operations",
           "library_ms": library_ms, "library": library, "shape": shape,
           "l2": "warm"}
    return row


def table_bert_kernels(torch, fa, ok, rng, errs, bert, layout):
    """Phase 10 rows of the BERT step's new kernels at the step's shapes:
    the segment-masked flash kernels at (32, 16, 512, 64) on q, k, v
    views of the packed qkv with BERT's ragged padding (512, 300, 129
    and 1 real tokens, cycled), and the LAMB kernels over the BERT-Large
    flat buffer in bf16.  Launches: the BERT phase's five steps, and for
    `lamb_phase1` the two unmasked FusedLAMB steps.  Flash bounds count
    the score pairs the segments leave (a query and a key of one
    segment); the LAMB phases have no single library call (null)."""
    import torch.nn.functional as F

    from apex_tpu_torch.ops.fused_dense import qkv_split_heads

    bf16, dev = torch.bfloat16, "cuda"
    launches, per_step = bert["launches"], bert["launches_per_step"]
    launches = dict(launches, lamb_phase1=bert[
        "unmasked_lamb_launches_2_steps"]["lamb_phase1"])
    per_step = dict(per_step, lamb_phase1=1)
    rows = []

    def row(name, kernel, *args):
        rows.append(table_row(name, launches[kernel], per_step[kernel],
                              errs[name], *args))

    b, h, s, d = BERT_BATCH, 16, BERT_SEQ, 64
    lengths = [512, 300, 129, 1]
    sc = 1.0 / math.sqrt(d)
    qkv = torch.randn((s, b, 3 * h * d), generator=rng, device=dev).to(bf16)
    q, k, v = qkv_split_heads(qkv, h, d)
    do = torch.randn((s, b, h, d), generator=rng,
                     device=dev).to(bf16).permute(1, 2, 0, 3)
    seg = pad_segments(torch, b, s, lengths)
    o, lse = fa.flash_fwd_cuda(q, k, v, sc, False, seg, seg)
    delta = torch.sum(do.float() * o.float(), dim=-1)
    n_real = seg.sum(dim=1).long()
    pairs = h * int((n_real ** 2 + (s - n_real) ** 2).sum().item())
    io, el = b * h * s * d * 2, 2
    mask = seg[:, None, :, None] == seg[:, None, None, :]
    shape = ("q,k,v (32,16,512,64) bf16 views of qkv (512,32,3072), "
             "segment ids (32,512): 512/300/129/1 real tokens")
    fwd_ms = time_ms(torch, lambda: fa.flash_fwd_cuda(q, k, v, sc, False,
                                                      seg, seg))
    fwd_plain = time_ms(torch, lambda: fa.attention_reference(
        q, k, v, softmax_scale=sc, q_segment_ids=seg, kv_segment_ids=seg),
        n=10)
    fwd_lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=sc))
    row("flash_attention_fwd_seg", "flash_attention_fwd", "cuda",
        "apex_tpu_torch/csrc/flash_attention.cu",
        "apex_tpu/ops/flash_attention.py:289", fwd_ms, fwd_plain, fwd_lib,
        "scaled_dot_product_attention(attn_mask=boolean segment mask)",
        4 * io + b * h * s * 4 + 2 * b * s * 4, 4 * pairs * d, shape)
    bwd_ms = time_ms(torch, lambda: fa.flash_bwd_cuda(
        q, k, v, do, lse, delta, sc, False, seg, seg))
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    out = fa.attention_reference(qg, kg, vg, softmax_scale=sc,
                                 q_segment_ids=seg, kv_segment_ids=seg)
    bwd_plain = time_ms(torch, lambda: torch.autograd.grad(
        out, (qg, kg, vg), do, retain_graph=True), n=10)
    del out
    out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask,
                                         scale=sc)
    bwd_lib = time_ms(torch, lambda: torch.autograd.grad(
        out, (qg, kg, vg), do, retain_graph=True))
    del out, qg, kg, vg
    row("flash_attention_bwd_seg", "flash_attention_bwd", "cuda",
        "apex_tpu_torch/csrc/flash_attention.cu",
        "apex_tpu/ops/flash_attention.py:564", bwd_ms, bwd_plain, bwd_lib,
        "scaled_dot_product_attention backward (autograd), boolean mask",
        7 * io + 2 * b * h * s * 4 + 2 * b * s * 4, 10 * pairs * d,
        shape + ", do a permuted view; delta outside the kernel")
    del qkv, q, k, v, do, o, lse, delta, mask
    torch.cuda.empty_cache()

    spec, n, seg_wd = layout
    tabs = ok.segment_tables(spec, n // 128, dev)
    segr, wdt = tabs["seg"], ok._table(seg_wd, dev)
    p = (torch.randn((n,), generator=rng, device=dev) * 0.05).to(bf16)
    m = (torch.randn((n,), generator=rng, device=dev) * 0.01).to(bf16)
    vv = (torch.randn((n,), generator=rng, device=dev).abs()
          * 1e-4).to(bf16)
    g = torch.randn((n,), generator=rng, device=dev).to(bf16)
    scal = ok._lamb_fold_scalars(0.8, 3, 0.9, 0.999, True, True, 1.0, False,
                                 device=dev)
    shape = f"m, v, g, p ({n},) bf16: the BERT-Large flat buffer"
    tables = segr.numel() * 4 + wdt.numel() * 4 + 8 * 4
    p1s_ms = time_ms(torch, lambda: ok.lamb_phase1_seg_triton(
        m, vv, g, p, scal, 1e-6, segr, wdt), n=20)
    p1s_plain = time_ms(torch, lambda: ok._lamb_phase1_reference(
        m, vv, g, p, scal, 1e-6, wd_rows=wdt[segr.long()]), n=10)
    row("lamb_phase1_seg", "lamb_phase1_seg", "triton",
        "apex_tpu_torch/ops/optimizer_kernels.py",
        "apex_tpu/ops/optimizer_kernels.py:530", p1s_ms, p1s_plain, None,
        None, 14 * n + tables, 16 * n,
        shape + "; per-tensor wd by row (no-decay mask)")
    p1_ms = time_ms(torch, lambda: ok.lamb_phase1_triton(
        m, vv, g, p, scal, 1e-6, 0.01), n=20)
    p1_plain = time_ms(torch, lambda: ok._lamb_phase1_reference(
        m, vv, g, p, scal, 1e-6, weight_decay=0.01), n=10)
    row("lamb_phase1", "lamb_phase1", "triton",
        "apex_tpu_torch/ops/optimizer_kernels.py",
        "apex_tpu/ops/optimizer_kernels.py:510", p1_ms, p1_plain, None,
        None, 14 * n + 8 * 4, 15 * n, shape + "; one wd 0.01")
    u = ok.lamb_phase1_triton(m, vv, g, p, scal, 1e-6, 0.01)[2]
    del m, vv, g
    views = [p[off:off + size] for off, size in zip(spec.offsets,
                                                    spec.sizes)]
    items = tabs["item_lo"].numel()
    ss_ms = time_ms(torch, lambda: ok.rows_sumsq_seg_triton(p, spec))
    ss_plain = time_ms(torch, lambda: ok._rows_sumsq_reference(p, spec),
                       n=10)
    ss_lib = time_ms(torch, lambda: torch._foreach_norm(views))
    row("rows_sumsq_seg", "rows_sumsq_seg", "triton",
        "apex_tpu_torch/ops/optimizer_kernels.py",
        "apex_tpu/ops/optimizer_kernels.py:887", ss_ms, ss_plain, ss_lib,
        "torch._foreach_norm over the 301 leaf views",
        2 * n + 8 * items + 4 * (len(spec.sizes) + 1)
        + 4 * len(spec.sizes), 2 * n,
        f"x ({n},) bf16 -> (301,) fp32; {items} work items")
    rows[-1]["max_rel_err"] = errs["rows_sumsq_seg_rel"]
    ratio = ok._table(torch.rand(len(spec.sizes), generator=rng,
                                 device=dev) + 0.5, dev)
    lr = torch.full((), 1e-6, device=dev)
    p2_ms = time_ms(torch, lambda: ok.lamb_phase2_seg_triton(
        p, u, segr, ratio, lr), n=20)
    p2_plain = time_ms(torch, lambda: ok._lamb_phase2_reference(
        p, u, ratio[segr.long()], lr), n=10)
    row("lamb_phase2_seg", "lamb_phase2_seg", "triton",
        "apex_tpu_torch/ops/optimizer_kernels.py",
        "apex_tpu/ops/optimizer_kernels.py:695", p2_ms, p2_plain, None,
        None, 6 * n + segr.numel() * 4 + ratio.numel() * 4 + 4, 3 * n,
        f"p, u ({n},) bf16; per-tensor ratio by row")
    del p, u, views
    torch.cuda.empty_cache()
    return rows


def table_dense_kernels(torch, sm, ok, rng, errs, gpt, bert, layout):
    """Table rows of the dense step's kernels at its shapes: the softmax
    pair at GPT's (192, 1024, 1024) causal bf16 (and, beside it, BERT's
    (32, 16, 512, 512) bf16 with the (32, 1, 1, 512) padding mask of
    512/300/129/0 real tokens), and the segmented Adam over the GPT-350M
    flat buffer in bf16.  Launches: the dense GPT phase's seven steps.
    Library calls: `torch._masked_softmax` (forward) and
    `torch._softmax_backward_data` (backward), both without the scale;
    the segmented Adam has none (null)."""
    bf16, dev = torch.bfloat16, "cuda"
    launches, per_step = gpt["launches"], gpt["launches_per_step"]
    rows = []

    def row(name, *args):
        rows.append(table_row(name, launches[name], per_step[name],
                              errs[name], *args))

    sc = 1.0 / math.sqrt(64)
    src = "apex_tpu_torch/ops/softmax.py"
    bh, s = 12 * 16, 1024
    x = torch.randn((bh, s, s), generator=rng, device=dev).to(bf16)
    g = torch.randn((bh, s, s), generator=rng, device=dev).to(bf16)
    causal = torch.triu(torch.ones((s, s), dtype=torch.bool, device=dev),
                        diagonal=1)
    el = x.numel()
    fwd_ms = time_ms(torch, lambda: sm.softmax_fwd_triton(x, None, sc, True))
    fwd_plain = time_ms(torch, lambda: sm.softmax_fwd_reference(
        x, None, sc, True), n=10)
    x4 = x.view(12, 16, s, s)
    fwd_lib = time_ms(torch, lambda: torch._masked_softmax(x4, causal, -1, 0))
    y = sm.softmax_fwd_triton(x, None, sc, True)
    bwd_ms = time_ms(torch, lambda: sm.softmax_bwd_triton(g, y, sc))
    bwd_plain = time_ms(torch, lambda: sm.softmax_bwd_reference(g, y, sc),
                        n=10)
    bwd_lib = time_ms(torch, lambda: torch._softmax_backward_data(
        g, y, -1, bf16))
    del x4

    # BERT's shape: the masked form, the mask read through its broadcast
    # strides
    b, h, sb = BERT_BATCH, 16, BERT_SEQ
    xb = torch.randn((b, h, sb, sb), generator=rng, device=dev).to(bf16)
    gb = torch.randn((b, h, sb, sb), generator=rng, device=dev).to(bf16)
    pad = (pad_segments(torch, b, sb, [512, 300, 129, 0]) == 0)
    mask = pad[:, None, None, :]
    elb = xb.numel()
    bfwd = time_ms(torch, lambda: sm.softmax_fwd_triton(xb, mask, sc, False))
    bfwd_plain = time_ms(torch, lambda: sm.softmax_fwd_reference(
        xb, mask, sc, False), n=10)
    bfwd_lib = time_ms(torch, lambda: torch._masked_softmax(xb, pad, -1, 1))
    # the BERT step's own mask: the bench's batch has no padding (the
    # table's case leaves 941 of every 2048 keys)
    step_mask = torch.zeros_like(mask)
    bfwd_step = time_ms(torch, lambda: sm.softmax_fwd_triton(
        xb, step_mask, sc, False))
    yb = sm.softmax_fwd_triton(xb, mask, sc, False)
    bbwd = time_ms(torch, lambda: sm.softmax_bwd_triton(gb, yb, sc))
    bbwd_plain = time_ms(torch, lambda: sm.softmax_bwd_reference(gb, yb, sc),
                         n=10)
    bbwd_lib = time_ms(torch, lambda: torch._softmax_backward_data(
        gb, yb, -1, bf16))
    del xb, gb, yb

    def bert_cols(ms, plain, lib, bytes_):
        return {"bert_masked_ms": ms, "bert_masked_plain_ms": plain,
                "bert_masked_library_ms": lib,
                "bert_masked_bound_ms": 1e3 * bytes_ / HBM_BYTES_PER_S,
                "bert_masked_shape": "x (32,16,512,512) bf16, mask "
                                     "(32,1,1,512) of 512/300/129/0 real "
                                     "tokens",
                "bert_launches": bert["launches"][rows[-1]["name"]],
                "bert_launches_per_step": bert["launches_per_step"][
                    rows[-1]["name"]]}

    # the forward's bytes: x only where the mask leaves it (a masked
    # element's output does not depend on x there), the mask, all of y
    row("softmax_fwd", "triton", src, "apex_tpu/ops/softmax.py:57", fwd_ms,
        fwd_plain, fwd_lib, "torch._masked_softmax (causal (S,S) mask, "
        "no scale)", bh * s * (s + 1) // 2 * 2 + el * 2, 6 * el,
        "x (192,1024,1024) bf16 (GPT scores (12,16,1024,1024)), causal")
    n_real = int((~pad).sum().item())
    rows[-1].update(bert_cols(bfwd, bfwd_plain, bfwd_lib,
                              h * sb * n_real * 2 + pad.numel() + elb * 2))
    rows[-1].update({
        "bert_step_mask_ms": bfwd_step,
        "bert_step_mask_bound_ms": 1e3 * (2 * elb * 2 + pad.numel())
        / HBM_BYTES_PER_S,
        "bert_step_mask": "(32,1,1,512) all False: the bench's BERT batch "
                          "has no padding"})
    row("softmax_bwd", "triton", src, "apex_tpu/ops/softmax.py:73", bwd_ms,
        bwd_plain, bwd_lib, "torch._softmax_backward_data (no scale)",
        3 * el * 2, 4 * el, "g, y (192,1024,1024) bf16")
    rows[-1].update(bert_cols(bbwd, bbwd_plain, bbwd_lib, 3 * elb * 2))
    del x, g, y, causal
    torch.cuda.empty_cache()

    spec, n, seg_wd = layout
    segr = ok.segment_tables(spec, n // 128, dev)["seg"]
    wdt = ok._table(seg_wd, dev)
    lrt = ok._table(torch.ones(len(spec.sizes), device=dev), dev)
    p = (torch.randn((n,), generator=rng, device=dev) * 0.05).to(bf16)
    m = (torch.randn((n,), generator=rng, device=dev) * 0.01).to(bf16)
    vv = (torch.randn((n,), generator=rng, device=dev).abs()
          * 1e-4).to(bf16)
    gg = torch.randn((n,), generator=rng, device=dev).to(bf16)
    scal = ok._adam_fold_scalars(1e-4, 3, 0.9, 0.999, True, 1.0, False,
                                 device=dev)
    rows_ = segr.long()
    seg_ms = time_ms(torch, lambda: ok.adam_flat_seg_triton(
        p, m, vv, gg, scal, 1e-8, True, segr, wdt, lrt), n=20)
    seg_plain = time_ms(torch, lambda: ok._adam_seg_reference(
        p, m, vv, gg, scal, 1e-8, True, wdt[rows_], lrt[rows_]), n=10)
    row("adam_seg", "triton", "apex_tpu_torch/ops/optimizer_kernels.py",
        "apex_tpu/ops/optimizer_kernels.py:228", seg_ms, seg_plain, None,
        None, 14 * n + segr.numel() * 4 + 2 * wdt.numel() * 4 + 9 * 4,
        17 * n, f"p, m, v, g ({n},) bf16: the GPT-350M flat buffer, "
        "per-tensor wd (no-decay mask) and lr scale by row")
    del p, m, vv, gg, rows_
    torch.cuda.empty_cache()
    return rows


def table_train_kernels(torch, fa, ln, ok, rng, errs, launches, per_step):
    """Phase 10 rows of the training path's kernels, at the step's shapes
    and layouts, warm L2 (every operand set but the LayerNorm's is larger
    than the 50 MB L2).  Bounds count what this data needs: each input
    read once and each output written once, and for causal attention
    only the score pairs at or below the diagonal."""
    import torch.nn.functional as F

    from apex_tpu_torch.ops.fused_dense import qkv_split_heads

    bf16 = torch.bfloat16
    dev = "cuda"
    rows = []

    def row(name, *args):
        rows.append(table_row(name, launches[name], per_step[name],
                              errs[name], *args))

    # flash attention: q, k, v strided views of the packed qkv, do a
    # permuted view, as the step gives them
    b, h, s, d = 12, 16, 1024, 64
    sc = 1.0 / math.sqrt(d)
    qkv = torch.randn((s, b, 3 * h * d), generator=rng, device=dev).to(bf16)
    q, k, v = qkv_split_heads(qkv, h, d)
    do = torch.randn((s, b, h, d), generator=rng,
                     device=dev).to(bf16).permute(1, 2, 0, 3)
    o, lse = fa.flash_fwd_cuda(q, k, v, sc, True)
    delta = torch.sum(do.float() * o.float(), dim=-1)
    pairs = b * h * s * (s + 1) // 2                 # causal score pairs
    el = 2
    io = b * h * s * d * el
    fwd_ms = time_ms(torch, lambda: fa.flash_fwd_cuda(q, k, v, sc, True))
    fwd_plain = time_ms(torch, lambda: fa.attention_reference(
        q, k, v, causal=True, softmax_scale=sc), n=10)
    fwd_lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=sc))
    shape = "q,k,v (12,16,1024,64) bf16 views of qkv (1024,12,3072), causal"
    row("flash_attention_fwd", "cuda", "apex_tpu_torch/csrc/flash_attention.cu",
        "apex_tpu/ops/flash_attention.py:289", fwd_ms, fwd_plain, fwd_lib,
        "scaled_dot_product_attention(is_causal=True)",
        4 * io + b * h * s * 4, 4 * pairs * d, shape)
    bwd_ms = time_ms(torch, lambda: fa.flash_bwd_cuda(
        q, k, v, do, lse, delta, sc, True))
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    out = fa.attention_reference(qg, kg, vg, causal=True, softmax_scale=sc)
    bwd_plain = time_ms(torch, lambda: torch.autograd.grad(
        out, (qg, kg, vg), do, retain_graph=True), n=10)
    del out
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                         scale=sc)
    bwd_lib = time_ms(torch, lambda: torch.autograd.grad(
        out, (qg, kg, vg), do, retain_graph=True))
    del out, qg, kg, vg
    row("flash_attention_bwd", "cuda",
        "apex_tpu_torch/csrc/flash_attention.cu",
        "apex_tpu/ops/flash_attention.py:564", bwd_ms, bwd_plain, bwd_lib,
        "scaled_dot_product_attention backward (autograd)",
        7 * io + 2 * b * h * s * 4, 10 * pairs * d,
        shape + ", do a permuted view; delta outside the kernel")
    del qkv, q, k, v, do, o, lse, delta
    torch.cuda.empty_cache()

    # LayerNorm backward at the GPT step's rows (batch 12 x seq 1024) and
    # BERT's (batch 32 x seq 512)
    def lnb_times(rows_, hid=1024, plain=True):
        x = torch.randn((rows_, hid), generator=rng, device=dev).to(bf16)
        w = torch.randn((hid,), generator=rng, device=dev).to(bf16)
        bb = torch.randn((hid,), generator=rng, device=dev).to(bf16)
        gy = torch.randn((rows_, hid), generator=rng, device=dev).to(bf16)
        _, mean, rstd = ln.norm_fwd_cuda(x, w, bb, 1e-5, False)
        ms = time_ms(torch, lambda: ln.norm_bwd_cuda(
            gy, x, mean, rstd, w, False))
        plain_ms = time_ms(torch, lambda: ln.norm_bwd_reference(
            gy, x, mean, rstd, w, False)) if plain else None
        xg, wg, bg = (t.detach().requires_grad_(True) for t in (x, w, bb))
        out = F.layer_norm(xg, (hid,), wg, bg, 1e-5)
        lib = time_ms(torch, lambda: torch.autograd.grad(
            out, (xg, wg, bg), gy, retain_graph=True))
        # g, x read and dx written once, mean and rstd, w, fp32 dw and db
        bytes_ = 3 * x.numel() * el + 2 * rows_ * 4 + hid * el + 2 * hid * 4
        return ms, plain_ms, lib, bytes_, 12 * x.numel()

    lnb = lnb_times(12288)
    row("layer_norm_bwd", "cuda", "apex_tpu_torch/csrc/layer_norm.cu",
        "apex_tpu/ops/layer_norm.py:79", *lnb[:3],
        "torch.nn.functional.layer_norm backward (autograd)", *lnb[3:],
        "g, x (12288,1024) bf16; dw, db fp32")
    bert_ms, _, bert_lib, bert_bytes, bert_ops = lnb_times(16384,
                                                           plain=False)
    rows[-1].update({
        "ms_at_bert_shape": bert_ms, "library_ms_at_bert_shape": bert_lib,
        "bound_ms_at_bert_shape": 1e3 * max(bert_bytes / HBM_BYTES_PER_S,
                                            bert_ops / FP32_FLOPS),
        "bert_shape": "g, x (16384,1024) bf16",
        "plan": list(ln.bwd_plan(12288, 1024, 2, ln._sm_count(
            torch.device("cuda", torch.cuda.current_device()))))})
    log("layer_norm bwd: " + json.dumps(
        {k: rows[-1][k] for k in ("ms", "bound_ms", "library_ms",
                                  "ms_at_bert_shape",
                                  "bound_ms_at_bert_shape",
                                  "library_ms_at_bert_shape", "plan")}))
    torch.cuda.empty_cache()

    # Adam over the flat GPT-350M buffers (bf16 state and grads)
    n = 354_877_440
    p = torch.randn((n,), generator=rng, device=dev).to(bf16)
    m = (torch.randn((n,), generator=rng, device=dev) * 0.1).to(bf16)
    vv = (torch.randn((n,), generator=rng, device=dev).abs()
          * 0.01).to(bf16)
    g = torch.randn((n,), generator=rng, device=dev).to(bf16)
    scal = ok._adam_fold_scalars(1e-4, 3, 0.9, 0.999, True, 1.0, False,
                                 device=dev)
    adam_ms = time_ms(torch, lambda: ok.adam_flat_triton(
        p, m, vv, g, scal, 1e-8, 0.0, True), n=20)
    adam_plain = time_ms(torch, lambda: ok._adam_reference(
        p, m, vv, g, scal, 1e-8, 0.0, True), n=10)
    step_t = torch.tensor(3.0, device=dev)
    adam_lib = time_ms(torch, lambda: torch._fused_adamw_(
        [p], [g], [m], [vv], [], [step_t], lr=1e-4, beta1=0.9, beta2=0.999,
        weight_decay=0.0, eps=1e-8, amsgrad=False, maximize=False), n=20)
    row("adam", "triton", "apex_tpu_torch/ops/optimizer_kernels.py",
        "apex_tpu/ops/optimizer_kernels.py:103", adam_ms, adam_plain,
        adam_lib, "torch._fused_adamw_ on the same flat buffers",
        7 * n * el, 15 * n, "p, m, v, g (354877440,) bf16")
    del p, m, vv, g
    torch.cuda.empty_cache()
    return rows


# -------------------- slice 16: the watchdog and the overload leg ----------


def watchdog_leg(torch, np, build_flagship_engine, ref_tokens, n_req=64,
                 max_new=32, stall_at=12, timeout_s=2.0):
    """Phase 13's watchdog at full width: the flagship engine (GPT-350M
    bf16, 64 slots, pages of 128, seed-0 weights: phase 3's) with phase
    3's 64 requests, an `EngineWatchdog(snapshot_every=1,
    stall_timeout_s=timeout_s)`, and the `serve.stall_step` fail point
    fired at the engine's `stall_at`-th step, mid-generation.  `check()`
    must raise `EngineStalledError` naming the stuck step; `restart()`
    builds a fresh engine on the card from the snapshot, and the drained
    run's tokens must be phase 3's (`ref_tokens`) bit for bit.  Returns
    the stall-to-raise and restart times."""
    from apex_tpu_torch.checkpoint import chaos
    from apex_tpu_torch.serve import EngineStalledError, EngineWatchdog

    eng = build_flagship_engine()
    c, s = eng.model_cfg, eng.serve_cfg
    prng = np.random.RandomState(0)
    for _ in range(n_req):
        plen = int(prng.randint(1, s.max_prompt_len + 1))
        eng.submit(prng.randint(0, c.vocab_size, plen).tolist(), max_new)
    dog = EngineWatchdog(eng, stall_timeout_s=timeout_s, snapshot_every=1)
    chaos.arm("serve.stall_step", stall_at)
    fins, tripped, stalled_t, steps = {}, None, None, 0
    t0 = time.perf_counter()
    try:
        while eng.pending:
            check(steps < 16 * max_new + 64 + 1000, "watchdog leg: no end")
            eng.step()
            for f in eng.poll():
                fins[f.request_id] = f
            if eng.stalled and stalled_t is None:
                stalled_t = time.perf_counter()
            try:
                dog.check()
            except EngineStalledError as e:
                raise_t = time.perf_counter()
                tripped = e
                eng = dog.restart()
                torch.cuda.synchronize()
                restart_s = time.perf_counter() - raise_t
                stall_to_raise_s = raise_t - stalled_t
            if eng.stalled:
                time.sleep(0.05)
            steps += 1
        eng._retire_finished()
        for f in eng.poll():
            fins[f.request_id] = f
    finally:
        chaos.disarm_all()
    wall = time.perf_counter() - t0
    check(tripped is not None, "watchdog leg: the stall did not trip")
    check(f"stuck at step {tripped.step}" in str(tripped)
          and tripped.snapshot_step == tripped.step,
          f"watchdog leg: {tripped}")
    check(dog.stalls == dog.restarts == 1, "watchdog leg: counts")
    check(eng.device.type == "cuda" and eng.watchdog is dog,
          "watchdog leg: the restarted engine")
    check(sorted(fins) == sorted(ref_tokens)
          and all(f.status == "ok" for f in fins.values()),
          "watchdog leg: a request did not end ok")
    drift = [r for r, f in fins.items() if f.tokens != ref_tokens[r]]
    check(not drift, f"watchdog leg: requests {drift} differ from phase 3's")
    check(eng.cache.free_pages == eng.kv_config.usable_pages
          and eng.telemetry.ledger.balance()["ok"],
          "watchdog leg: pool or ledger")
    rec = eng.serve_record()
    check(rec["serve_watchdog_stalls"] == rec["serve_watchdog_restarts"]
          == 1, f"watchdog leg: serve_record {rec}")
    return {"stuck_step": tripped.step,
            "stalled_for_s": tripped.stalled_for_s,
            "stall_to_raise_s": stall_to_raise_s, "restart_s": restart_s,
            "steps": steps, "wall_s": wall, "requests": len(fins),
            "bitwise_phase3": True}


def overload_leg(torch, np, build_flagship_engine):
    """bench.py's `_serve_overload_bench` (bench.py:554-619) at full
    width on the card: the flagship engine with max_queue_depth 2 x 64
    and shed-lowest-deadline; 4 x 64 requests of 1..128 prompt tokens
    and 1..128 new ones from RandomState(0), every odd one with a
    deadline of 120 s; drained.  Gates: the ledger balances and the page
    pool is whole again.  Returns the leg's numbers."""
    eng = build_flagship_engine(serve_overrides={
        "max_queue_depth": 2 * 64, "shed_policy": "shed-lowest-deadline"})
    n_slots = eng.serve_cfg.n_slots
    check(n_slots == 64, f"overload leg: {n_slots} slots")
    n_requests = 4 * n_slots
    max_new = eng.serve_cfg.max_new_cap
    rng = np.random.RandomState(0)
    mp = eng.serve_cfg.max_prompt_len
    budgets = {}
    t0 = time.perf_counter()
    for i in range(n_requests):
        plen = int(rng.randint(1, mp + 1))
        budget = int(rng.randint(1, max_new + 1))
        dl = 120_000.0 if i % 2 else None
        rid = eng.submit(rng.randint(0, eng.model_cfg.vocab_size,
                                     plen).tolist(), budget, deadline_ms=dl)
        budgets[rid] = budget
    fins, steps = {}, 0
    while eng.pending:
        check(steps < n_requests * max_new + 64, "overload storm: no end")
        eng.step()
        for f in eng.poll():
            fins[f.request_id] = f
        steps += 1
    eng._retire_finished()
    for f in eng.poll():
        fins[f.request_id] = f
    wall = time.perf_counter() - t0
    led = eng.telemetry.ledger
    ok_ = [f for f in fins.values() if f.status == "ok"]
    good_tokens = sum(len(f.tokens) for f in ok_)
    out = {
        "n_requests": n_requests, "n_ok": led.n_retired,
        "n_shed": led.n_shed, "n_expired": led.n_expired,
        "shed_fraction": (led.n_shed + led.n_expired) / n_requests,
        "goodput_tokens_per_sec": good_tokens / wall,
        "good_tokens": good_tokens, "steps": steps, "wall_s": wall,
        "balance_ok": led.balance()["ok"],
        "pool_reconciled": (eng.cache.free_pages
                            == eng.kv_config.usable_pages),
        "recompile_ok": eng.recompile_ok,
        "queue_saturation_peak": eng.telemetry.peaks["queue_saturation"]}
    check(out["balance_ok"] and out["pool_reconciled"],
          f"overload leg: a gate failed {out}")
    check(len(fins) == n_requests and all(
        len(f.tokens) == budgets[f.request_id] for f in ok_)
        and all(0 <= t < eng.model_cfg.vocab_size for f in ok_
                for t in f.tokens), "overload leg: an ok request's tokens")
    return out


def slice16_phase(torch, np, build_flagship_engine, ref_tokens):
    """Phase 13 (module docstring).  `ref_tokens`: phase 3's tokens by
    request."""
    t0 = time.perf_counter()
    dog = watchdog_leg(torch, np, build_flagship_engine, ref_tokens)
    log("watchdog " + json.dumps(dog))
    torch.cuda.empty_cache()
    storm = overload_leg(torch, np, build_flagship_engine)
    log("overload " + json.dumps(storm))
    torch.cuda.empty_cache()
    log(f"phase 13 {time.perf_counter() - t0:.1f}s")
    return {"watchdog": dog, "overload": storm}


# ----------------------------- slice 17 (PR 17) -----------------------------

VIRTUAL_SHARDS = 4


def check_virtual_shards(torch, ok, rng, spec, n, seg_wd, what):
    """Phase 2's virtual shards: the `n`-element flat buffer of `spec`
    (GPT-350M's or BERT-Large's lane-aligned layout, bf16 state and grads,
    zero padding) cut into `VIRTUAL_SHARDS` shards of n / 4 elements, as
    the ranks of a ZeRO optimizer hold it; tensors straddle the shard
    edges.  Each rank's shard goes through `adam_flat_seg` (per-tensor wd
    and lr scales), `lamb_phase1_seg` and `lamb_phase2_seg` at its row
    offset, one after another on the one card: each launch bit for bit
    its plain version on the same shard, and the shards' results
    concatenated bit for bit one whole-buffer launch.  The per-tensor
    sums of squares of two buffers, `per_tensor_sumsq_shard` per shard
    summed in rank order, against the whole buffer's (`rows_sumsq_seg`)
    within 1e-5 relative (the shards cut a straddling tensor's rows into
    other work items: another order of fp32 sums), and the same bits on
    a second run.  Times one shard's launch (rank 1) beside the whole
    buffer's, for each kernel.  Returns the errors and those times."""
    dev = "cuda"
    bf16 = torch.bfloat16
    real = torch.zeros(n, dtype=torch.bool, device=dev)
    for off, size in zip(spec.offsets, spec.sizes):
        real[off:off + size] = True

    def buf(scale, absval=False):
        x = torch.randn((n,), generator=rng, device=dev) * scale
        return torch.where(real, x.abs() if absval else x, 0.0).to(bf16)

    p, m, v, g = buf(0.05), buf(0.01), buf(1e-4, absval=True), buf(1.0)
    del real
    n_t = len(spec.sizes)
    seg_full = ok.segment_tables(spec, n // 128, dev)["seg"]
    wdt = ok._table(seg_wd, dev)
    lrs = 0.5 + torch.rand(n_t, generator=rng, device=dev)
    lrt = ok._table(lrs, dev)
    ratio = 0.5 + torch.rand(n_t, generator=rng, device=dev)
    rt = ok._table(ratio, dev)
    lr = torch.full((), 1e-2, device=dev)
    size = n // VIRTUAL_SHARDS
    rows = size // 128
    check(n % (VIRTUAL_SHARDS * 128) == 0,
          f"{what}: {n} elements are not {VIRTUAL_SHARDS} shards of whole "
          f"rows")
    straddle = sum(1 for off, sz in zip(spec.offsets, spec.sizes)
                   if off // size != (off + sz - 1) // size)
    check(straddle > 0, f"{what}: no tensor straddles a shard edge")
    adam_sc = ok._adam_fold_scalars(1e-4, 3, 0.9, 0.999, True, 1.0, False,
                                    device=dev)
    lamb_sc = ok._lamb_fold_scalars(0.8, 3, 0.9, 0.999, True, True, 1.0,
                                    False, device=dev)

    # (p, m, v, g) in, the kernel's outputs back (in place on its state)
    def adam(x, y, z, gg, **kw):
        return ok.adam_flat_seg(x, y, z, gg, 1e-4, 3, wd_values=seg_wd,
                                lr_scale_values=lrs, spec=spec, **kw)

    def lamb1(x, y, z, gg, **kw):
        return ok.lamb_phase1_seg(y, z, gg, x, 0.8, 3, wd_values=seg_wd,
                                  spec=spec, beta1=0.9, beta2=0.999,
                                  eps=1e-6, **kw)

    def lamb2(x, y, z, gg, **kw):            # u is m's buffer
        return (ok.lamb_phase2_seg(x, y, ratio, spec, lr, **kw),)

    kernels = {
        "adam_seg": (adam, lambda x, y, z, gg, sg: ok._adam_seg_reference(
            x, y, z, gg, adam_sc, 1e-8, True, wdt[sg], lrt[sg])),
        "lamb_phase1_seg": (lamb1, lambda x, y, z, gg, sg:
                            ok._lamb_phase1_reference(
                                y, z, gg, x, lamb_sc, 1e-6,
                                wd_rows=wdt[sg])),
        "lamb_phase2_seg": (lamb2, lambda x, y, z, gg, sg: (
            ok._lamb_phase2_reference(x, y, rt[sg], lr),))}
    # the timed launches: the launchers alone, their scalars and tables
    # made beforehand (the public functions add a few small kernels a
    # call, which a quarter of the buffer no longer hides)
    raw = {
        "adam_seg": lambda x, y, z, gg, sg: ok.adam_flat_seg_triton(
            x, y, z, gg, adam_sc, 1e-8, True, sg, wdt, lrt),
        "lamb_phase1_seg": lambda x, y, z, gg, sg: ok.lamb_phase1_seg_triton(
            y, z, gg, x, lamb_sc, 1e-6, sg, wdt),
        "lamb_phase2_seg": lambda x, y, z, gg, sg: ok.lamb_phase2_seg_triton(
            x, y, sg, rt, lr)}

    def sl(r):
        return slice(r * size, (r + 1) * size)

    def at(r):
        return {"row_offset": r * rows, "padded_total": n}

    out = {"shards": VIRTUAL_SHARDS, "shard_elements": size,
           "tensors_straddling_an_edge": straddle, "max_err": {},
           "ms": {}}
    for name, (launch, plain) in kernels.items():
        whole = launch(p.clone(), m.clone(), v.clone(), g)
        worst = 0.0
        for r in range(VIRTUAL_SHARDS):
            s_ = sl(r)
            got = launch(p[s_].clone(), m[s_].clone(), v[s_].clone(), g[s_],
                         **at(r))
            ref = plain(p[s_], m[s_], v[s_], g[s_],
                        seg_full[r * rows:(r + 1) * rows].long())
            torch.cuda.synchronize()
            for a, b, w in zip(got, ref, whole):
                worst = max(worst, (a.float() - b.float()).abs().max().item())
                check(torch.equal(a, b), f"{what} {name} shard {r}: not bit "
                      f"for bit its plain version")
                check(torch.equal(a, w[s_]), f"{what} {name} shard {r}: not "
                      f"bit for bit the whole-buffer launch")
            del got, ref
        out["max_err"][name] = worst
        del whole
        # one shard's launch (rank 1) beside the whole buffer's
        shard = [x[sl(1)].clone() for x in (p, m, v, g)]
        full = [p.clone(), m.clone(), v.clone(), g]
        seg1 = ok.shard_tables(spec, n // 128, rows, rows, dev)["seg"]
        out["ms"][name] = {
            "shard": time_ms(torch, lambda: raw[name](*shard, seg1), n=20,
                             warm=2),
            "whole": time_ms(torch, lambda: raw[name](*full, seg_full),
                             n=20, warm=2)}
        del shard, full
        torch.cuda.empty_cache()
    # the per-tensor sums of squares: the shards' partials in rank order
    rels = []
    for x in (p, m):
        whole = ok.rows_sumsq_seg_triton(x, spec)
        runs = []
        for _ in range(2):
            acc = torch.zeros_like(whole)
            for r in range(VIRTUAL_SHARDS):
                acc = acc + ok.per_tensor_sumsq_shard(x[sl(r)], spec, r, n)
            runs.append(acc)
        torch.cuda.synchronize()
        check(torch.equal(runs[0], runs[1]), f"{what} per_tensor_sumsq_shard:"
              f" two runs differ")
        rels.append(((runs[0] - whole).abs()
                     / whole.abs().clamp_min(1e-30)).max().item())
        check(rels[-1] <= 1e-5, f"{what} per_tensor_sumsq_shard: max rel err "
              f"{rels[-1]:.3e} vs the whole buffer")
    out["max_err"]["rows_sumsq_seg_rel"] = max(rels)
    xs = p[sl(1)].clone()
    out["ms"]["rows_sumsq_seg"] = {
        "shard": time_ms(torch, lambda: ok.rows_sumsq_seg_triton(
            xs, spec, row_offset=rows, padded_total=n), n=20, warm=2),
        "whole": time_ms(torch, lambda: ok.rows_sumsq_seg_triton(p, spec),
                         n=20, warm=2)}
    del p, m, v, g, xs
    torch.cuda.empty_cache()
    return out


def zero2_sweep_leg(torch, fa, ln, ok, warmup=2, steps=10):
    """Slice 17 (a): bench.py's `_zero2_bucket_sweep` at full width.  GPT
    (vocab 50304, hidden 1024, 8 layers, 16 heads, seq 1024) in bf16 with
    bf16 logits and flash attention, batch 8, seed-0 weights, through
    `ddp.make_train_step` with `DistributedFusedAdam(num_shards=1,
    lr=1e-4, n_buckets, master_dtype=bf16)` on the one-rank NCCL group,
    for n_buckets 1, 2 and 4: `warmup` + `steps` steps each (8 flash
    forwards and backwards, 17 LayerNorm forwards and backwards and one
    Adam launch a bucket a step), tokens/s and peak memory, a step with
    no host sync; the last losses of n_buckets 2 and 4 within 5e-3
    relative of n_buckets 1's (a step is not bit for bit repeatable on
    the card, the embedding's backward adds by atomics, and each bucket's
    leaves lie at other offsets of their gathered buffer, where cuBLAS
    picks its kernels by the operands' alignment; two runs of n_buckets
    1 ended 9.6e-5 apart, n_buckets 2 6.1e-4 from 1).  The optimizer alone, as tests/test_distributed_optimizers
    .py:361 holds it: three steps of the same seeded bf16 grads at full
    width (grad_sync_dtype bf16) give n_buckets 2 and 4 the params of
    n_buckets 1 bit for bit, and those of FusedAdam(lr=1e-4, master
    bf16).  Then three steps of FusedAdam, of FusedAdam again and of the
    n_buckets 1 ZeRO optimizer through the same `make_train_step` from
    the same weights: the ZeRO losses within 1e-3 relative of
    FusedAdam's and its params within 0.1 of FusedAdam's update (L2),
    beside FusedAdam's own run-to-run difference (the step is not bit for
    bit repeatable: Adam turns the atomics' last-bit differences in
    small grads into differences of up to lr a step)."""
    from apex_tpu_torch.models import gpt as gpt_mod
    from apex_tpu_torch.optimizers import DistributedFusedAdam, FusedAdam
    from apex_tpu_torch.optimizers import flat as F
    from apex_tpu_torch.parallel import ddp

    bf16 = torch.bfloat16
    batch, seq = 8, 1024
    model = gpt_mod.GPT(gpt_mod.GPTConfig(
        vocab_size=50304, seq_len=seq, hidden=1024, num_layers=8,
        num_heads=16, dropout=0.0, dtype=bf16, logits_dtype=bf16,
        use_flash_attention=True))
    params = model.init(seed=0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, 50304, (batch, seq), generator=gen,
                           device="cuda", dtype=torch.int32)
    labels = torch.roll(tokens, -1, dims=1)

    def loss_fn(p, b):
        return model.loss(p, b[0], b[1])

    def zero(nb, **kw):
        return DistributedFusedAdam(num_shards=1, lr=1e-4, n_buckets=nb,
                                    master_dtype=bf16, **kw)

    def leaves_of(opt, state):
        leaves = (opt.full_leaves(state) if hasattr(opt, "full_leaves")
                  else F.unflatten_leaves(state.params, opt.spec))
        return [x.clone() for x in leaves]

    out = {"config": "GPT vocab 50304, hidden 1024, 8 layers, 16 heads, "
                     "seq 1024, batch 8, bf16 (bf16 logits), flash; "
                     "DistributedFusedAdam(num_shards=1, lr=1e-4, "
                     "master bf16) through ddp.make_train_step on a "
                     "one-rank NCCL group",
           "tokens_per_s": {}, "peak_mem_gib": {}, "step_ms": {},
           "launches": {}, "losses": {}, "host_syncs_per_step": {}}
    for nb in (1, 2, 4):
        opt = zero(nb)
        state = opt.init(params)
        check(opt.shard_layout()["n_buckets"] == nb,
              f"zero2: {opt.shard_layout()['n_buckets']} buckets, want {nb}")
        step = zero_step_fn(ddp.make_train_step(loss_fn, opt))
        per_step = {"flash_attention_fwd": 8, "flash_attention_bwd": 8,
                    "layer_norm_fwd": 17, "layer_norm_bwd": 17, "adam": nb,
                    "adam_seg": 0}
        state, res = train_loop(torch, fa, ln, ok, f"zero2 n_buckets={nb}",
                                step, state, ((tokens, labels),), per_step,
                                warmup, steps)
        state, syncs = step_without_sync(torch, step, state,
                                         (tokens, labels))
        key = str(nb)
        out["tokens_per_s"][key] = batch * seq * steps / res["window_s"]
        out["peak_mem_gib"][key] = res["peak_mem_gib"]
        out["step_ms"][key] = res["step_ms"]
        out["launches"][key] = {k: res["launches"][k] for k in per_step}
        out["losses"][key] = res["losses"]
        out["host_syncs_per_step"][key] = len(syncs)
        del state, opt, step
        torch.cuda.empty_cache()
    last = {k: v[-1] for k, v in out["losses"].items()}
    out["last_loss_rel_diff_vs_1_bucket"] = {
        k: abs(last[k] - last["1"]) / abs(last["1"]) for k in ("2", "4")}
    check(max(out["last_loss_rel_diff_vs_1_bucket"].values()) <= 5e-3,
          f"zero2: last losses by n_buckets {last}")

    # the optimizer alone: the same seeded grads, three steps
    ggen = torch.Generator(device="cuda").manual_seed(7)
    grads = [torch.randn(leaf.shape, generator=ggen, device="cuda").to(bf16)
             for leaf in F.tree_leaves(params)]
    finals = {}
    for name, opt in (("1", zero(1, grad_sync_dtype=bf16)),
                      ("2", zero(2, grad_sync_dtype=bf16)),
                      ("4", zero(4, grad_sync_dtype=bf16)),
                      ("fused_adam", FusedAdam(lr=1e-4, master_dtype=bf16))):
        state = opt.init(params)
        for _ in range(3):
            if hasattr(opt, "full_leaves"):
                _, state = opt.step(state, grads, gather_params=False)
            else:
                _, state = opt.step(state, F.tree_from_leaves(opt.spec,
                                                              grads))
        finals[name] = leaves_of(opt, state)
        del state, opt
    same = {k: all(torch.equal(a, b) for a, b in zip(finals[k], finals["1"]))
            for k in ("2", "4", "fused_adam")}
    out["optimizer_alone_bit_for_bit_vs_1_bucket"] = same
    check(all(same.values()), f"zero2: the optimizer alone, three steps of "
          f"the same grads: bit for bit with n_buckets 1 {same}")
    del finals, grads

    def three_steps(opt):
        state = opt.init(params)
        step = ddp.make_train_step(loss_fn, opt)
        p0 = leaves_of(opt, state)
        losses = []
        for _ in range(3):
            state, _, loss = step(state, None, (tokens, labels))
            losses.append(float(loss))
        return p0, leaves_of(opt, state), losses

    _, z, zl = three_steps(zero(1))
    a0, a, al = three_steps(FusedAdam(lr=1e-4, master_dtype=bf16))
    _, b, _ = three_steps(FusedAdam(lr=1e-4, master_dtype=bf16))
    upd = sum((y.float() - x.float()).norm() ** 2
              for x, y in zip(a0, a)).sqrt().item()

    def rel(u, w):
        return sum((x.float() - y.float()).norm() ** 2
                   for x, y in zip(u, w)).sqrt().item() / max(upd, 1e-30)

    vs = {"steps": 3, "losses_zero": zl, "losses_fused_adam": al,
          "loss_rel_diff_max": max(abs(x - y) / abs(y)
                                   for x, y in zip(zl, al)),
          "params_diff_rel_to_update": rel(z, a),
          "fused_adam_run_to_run_rel_to_update": rel(b, a),
          "bit_for_bit": all(torch.equal(x, y) for x, y in zip(z, a))}
    out["vs_fused_adam"] = vs
    check(vs["loss_rel_diff_max"] <= 1e-3
          and vs["params_diff_rel_to_update"] <= 0.1,
          f"zero2: three steps against FusedAdam's {vs}")
    del z, a, a0, b, params
    torch.cuda.empty_cache()
    return out


def microbatch_leg(torch, fa, ln, ok, warmup=1, steps=4):
    """Slice 17 (b): phase 5's GPT-350M step (batch 12 x 1024, bf16, bf16
    logits, flash, FusedAdam(lr=1e-4, master bf16)) through
    `ddp.make_train_step(num_microbatches=4, main_grad_dtype=float32)` on
    the one-rank NCCL group: four microbatches of 3 sequences a step,
    their bf16 grads added into the persistent fp32 main-grad buffer and
    divided by 4 after, one all-reduce of it, one Adam launch (96 flash
    forwards and backwards and 196 LayerNorm forwards and backwards a
    step).  The loss falls over the 5 steps, no host sync; tokens/s, peak
    memory and one profiled step."""
    from apex_tpu_torch.models import gpt as gpt_mod
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.parallel import ddp

    bf16 = torch.bfloat16
    batch, seq = 12, 1024
    model = gpt_mod.gpt_350m(vocab_size=50304, seq_len=seq, dropout=0.0,
                             dtype=bf16, logits_dtype=bf16,
                             use_flash_attention=True)
    params = model.init(seed=0)
    opt = FusedAdam(lr=1e-4, master_dtype=bf16)
    state = opt.init(params)
    del params
    grad_dtypes = set()
    step_flat = opt.step_flat

    def recording(st, g_flat, **kw):
        grad_dtypes.add(str(g_flat.dtype))
        return step_flat(st, g_flat, **kw)

    opt.step_flat = recording
    step = ddp.make_train_step(lambda p, b: model.loss(p, b[0], b[1]), opt,
                               num_microbatches=4,
                               main_grad_dtype=torch.float32)

    def carry(st, b):
        st, _, loss = step(st, None, b)
        return st, loss

    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, 50304, (batch, seq), generator=gen,
                           device="cuda", dtype=torch.int32)
    labels = torch.roll(tokens, -1, dims=1)
    per_step = {"flash_attention_fwd": 96, "flash_attention_bwd": 96,
                "layer_norm_fwd": 196, "layer_norm_bwd": 196, "adam": 1}
    state, res = train_loop(torch, fa, ln, ok, "GPT-350M 4 microbatches",
                            carry, state, ((tokens, labels),), per_step,
                            warmup, steps)
    check(grad_dtypes == {"torch.float32"},
          f"microbatch leg: the optimizer saw grads of {grad_dtypes}")
    state, syncs = step_without_sync(torch, carry, state, (tokens, labels))
    state, prof = profile_step(
        torch, carry, state, ((tokens, labels),),
        {"flash_attention_fwd": lambda k: "flash_fwd_kernel" in k,
         "flash_attention_bwd": lambda k: "flash_bwd_kernel" in k,
         "layer_norm_fwd": lambda k: "ln_fwd_kernel" in k,
         "layer_norm_bwd": lambda k: "ln_bwd_" in k,
         "adam": lambda k: k == "_adam_kernel"})
    del state, opt, step
    torch.cuda.empty_cache()
    return dict(res, config="GPT-350M bf16, batch 12 x seq 1024 as 4 "
                "microbatches of 3, bf16 logits, flash, fp32 main grads, "
                "FusedAdam(lr=1e-4, master bf16), ddp.make_train_step on a "
                "one-rank NCCL group",
                tokens_per_s=batch * seq * steps / res["window_s"],
                host_syncs_per_step=len(syncs), grad_dtypes=sorted(
                    grad_dtypes), profile=prof)


def bf16_ulps(torch, a, b):
    """Elementwise distance of two bf16 tensors in units in the last place
    (the difference of their bit patterns mapped to ordered integers)."""
    def key(x):
        i = x.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (key(a) - key(b)).abs()


def lamb_alone_check(torch, ok, params, mask, zero_opt, steps=3):
    """DistributedFusedLAMB's own math at full width against FusedLAMB's:
    `steps` steps of `zero_opt()` (num_shards=1) and of FusedLAMB with the
    same hyperparameters on the same seeded bf16 grads, at two scales:
    grads of global norm below max_grad_norm (no clipping, so the clip
    ratio is exactly 1 in both), and N(0, 1) grads, which clip.  Each
    scale reports both global norms (FusedLAMB's ‖g‖ from `l2norm_flat`
    of the bf16 buffer; the ZeRO step's √(Σ over ranks of ‖g_r‖²) of the
    fp32 buffer, here one rank) and, for p, m and v after the steps,
    whether they are bit for bit, how many elements differ and by how
    many bf16 ULPs at most."""
    from apex_tpu_torch.optimizers import FusedLAMB
    from apex_tpu_torch.optimizers import flat as F

    ggen = torch.Generator(device="cuda").manual_seed(7)
    unit = [torch.randn(leaf.shape, generator=ggen, device="cuda")
            for leaf in F.tree_leaves(params)]
    out = {}
    for name, scale in (("unclipped", 1e-6), ("clipped", 1.0)):
        grads = [(g * scale).to(torch.bfloat16) for g in unit]
        zopt = zero_opt()
        zstate = zopt.init(params)
        fopt = FusedLAMB(lr=zopt.lr, weight_decay=zopt.weight_decay,
                         master_dtype=zopt.master_dtype,
                         wd_mask=zopt.wd_mask)
        fstate = fopt.init(params)
        tree = F.tree_from_leaves(fopt.spec, grads)
        for _ in range(steps):
            _, zstate = zopt.step(zstate, grads, gather_params=False)
            _, fstate = fopt.step(fstate, tree)
        (zg,) = zopt.flatten_grads(grads)
        fg = F.flatten(tree, torch.bfloat16, pad_to=ok.FLAT_TILE,
                       align=fopt.spec.align)
        gz = torch.sqrt(torch.square(ok.l2norm_flat(zg))).item()
        gf = ok.l2norm_flat(fg).item()
        r = {"global_norm_zero": gz, "global_norm_fused_lamb": gf,
             "global_norms_equal": gz == gf}
        n = fstate.params.numel()
        for key, z, f in (("p", zstate.params_shard, fstate.params),
                          ("m", zstate.exp_avg, fstate.exp_avg),
                          ("v", zstate.exp_avg_sq, fstate.exp_avg_sq)):
            u = bf16_ulps(torch, z[:n], f)
            r[key] = {"bit_for_bit": bool(torch.equal(z[:n], f)),
                      "n_differ": int((u > 0).sum()),
                      "max_ulps": int(u.max())}
        out[name] = r
        del zstate, fstate, zopt, fopt, grads, tree, zg, fg
        torch.cuda.empty_cache()
    out["n_elements"] = n
    out["steps"] = steps
    return out


def zero_lamb_leg(torch, fa, ln, ok, warmup=1, steps=4):
    """Slice 17 (c): phase 6's BERT-Large step (bf16, batch 32 x 512,
    flash, MLM + NSP) with `DistributedFusedLAMB(num_shards=1, lr=1e-4,
    weight_decay=0.01, master bf16, wd_mask=no-decay)` through
    `ddp.make_train_step` on the one-rank NCCL group: each step one
    reduce-scatter, one all-reduce of the grads' sum of squares, one
    `lamb_phase1_seg` at the shard's offset, the per-tensor sums of
    squares of p and u over the shard (two `rows_sumsq_seg` calls) and
    their all-reduce, one `lamb_phase2_seg`, no host sync; seq/s and peak
    memory.  The optimizer alone (`lamb_alone_check`): three steps of
    the same seeded grads, clipped and not, bit for bit FusedLAMB's in
    p, m and v.  Then two steps of it against two of phase 6's FusedLAMB
    step (twice) from the same weights and batch: the losses within 1e-3
    relative, the params' difference within three times FusedLAMB's own
    run-to-run difference (L2, both relative to FusedLAMB's update; the
    step is not bit for bit repeatable on the card, and two FusedLAMB
    runs differ by 1.3 % of the update on an H100)."""
    from apex_tpu_torch.models import bert as bert_mod
    from apex_tpu_torch.optimizers import DistributedFusedLAMB, FusedLAMB
    from apex_tpu_torch.parallel import ddp
    from apex_tpu_torch.transformer.pipeline_parallel import (
        get_params_for_weight_decay_optimization)
    from apex_tpu_torch.transformer.training import make_tp_dp_train_step

    bf16 = torch.bfloat16
    cfg = bert_mod.BertConfig(seq_len=BERT_SEQ, dtype=bf16,
                              use_flash_attention=True)
    model = bert_mod.Bert(cfg)
    params = model.init(seed=0)
    mask = get_params_for_weight_decay_optimization(params)
    tokens, labels = bert_data(torch, cfg, BERT_BATCH)

    def loss_fn(p, b):
        return model.loss(p, b[0], *b[1])

    def zero_opt():
        return DistributedFusedLAMB(num_shards=1, lr=1e-4, weight_decay=0.01,
                                    master_dtype=bf16, wd_mask=mask)

    opt = zero_opt()
    state = opt.init(params)
    step = ddp.make_train_step(loss_fn, opt)

    def carry(st, b):
        st, _, loss = step(st, None, b)
        return st, loss

    per_step = {"flash_attention_fwd": 24, "flash_attention_bwd": 24,
                "layer_norm_fwd": 50, "layer_norm_bwd": 50,
                "lamb_phase1_seg": 1, "rows_sumsq_seg": 2,
                "lamb_phase2_seg": 1, "lamb_phase1": 0}
    state, res = train_loop(torch, fa, ln, ok, "BERT-Large ZeRO LAMB", carry,
                            state, ((tokens, labels),), per_step, warmup,
                            steps)
    state, syncs = step_without_sync(torch, carry, state, (tokens, labels))
    del state, opt, step
    torch.cuda.empty_cache()
    alone = lamb_alone_check(torch, ok, params, mask, zero_opt)
    log("ZeRO LAMB vs FusedLAMB, the optimizer alone " + json.dumps(alone))
    check(all(alone[c][k]["bit_for_bit"] for c in ("unclipped", "clipped")
              for k in ("p", "m", "v")),
          f"ZeRO LAMB vs FusedLAMB, the optimizer alone: {alone}")
    # two steps of each from the same weights
    zopt = zero_opt()
    zstate = zopt.init(params)
    zstep = ddp.make_train_step(loss_fn, zopt)
    zl = []
    for _ in range(2):
        zstate, _, loss = zstep(zstate, None, (tokens, labels))
        zl.append(float(loss))
    zp = zstate.params_shard.clone()
    del zstate, zopt, zstep

    def fused_lamb_two_steps():
        fopt = FusedLAMB(lr=1e-4, weight_decay=0.01, master_dtype=bf16,
                         wd_mask=mask)
        fstate = fopt.init(params)
        p0 = fstate.params.clone()
        fstep = make_tp_dp_train_step(
            model, fopt, loss_fn=lambda p, t, lab: model.loss(p, t, *lab))
        fl = []
        for _ in range(2):
            fstate, loss = fstep(fstate, tokens, labels)
            fl.append(float(loss))
        return p0, fstate.params, fl

    p0, fp, fl = fused_lamb_two_steps()
    _, fp2, _ = fused_lamb_two_steps()
    zp = zp[:fp.numel()]
    upd = (fp.float() - p0.float()).norm().item()
    rel = (zp.float() - fp.float()).norm().item() / max(upd, 1e-30)
    floor = (fp2.float() - fp.float()).norm().item() / max(upd, 1e-30)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(zl, fl))
    vs = {"steps": 2, "losses_zero": zl, "losses_fused_lamb": fl,
          "loss_rel_diff_max": loss_rel, "params_diff_rel_to_update": rel,
          "fused_lamb_run_to_run_rel_to_update": floor,
          "bit_for_bit": bool(torch.equal(zp, fp))}
    check(loss_rel <= 1e-3 and rel <= 3 * floor,
          f"ZeRO LAMB vs FusedLAMB: {vs}")
    del fp, fp2, p0, zp, params
    torch.cuda.empty_cache()
    return dict(res, config="BERT-Large bf16, batch 32 x 512, flash, "
                "DistributedFusedLAMB(num_shards=1, lr=1e-4, wd 0.01, "
                "master bf16, no-decay wd_mask) through ddp.make_train_step "
                "on a one-rank NCCL group",
                seq_per_s=BERT_BATCH * steps / res["window_s"],
                host_syncs_per_step=len(syncs), vs_fused_lamb=vs,
                optimizer_alone=alone)


SHARD_ROWS = {"adam_seg": ("GPT-350M", "adam_seg"),
              "lamb_phase1_seg": ("BERT-Large", "lamb_phase1_seg"),
              "rows_sumsq_seg": ("BERT-Large", "rows_sumsq_seg"),
              "lamb_phase2_seg": ("BERT-Large", "lamb_phase2_seg")}


def add_slice17_columns(rows, shards, slice17):
    """The kernel table's slice-17 columns: the four segmented kernels'
    shard offsets (one shard of four beside the whole buffer, phase 2)
    and, on every row a slice-17 leg launched, its launches by leg."""
    legs = {f"zero2 n_buckets={nb}": c for nb, c in
            slice17["zero2_sweep"]["launches"].items()}
    for leg in ("microbatches", "zero_lamb", "resnet_o2"):
        legs[leg] = slice17[leg]["launches"]
    for row in rows:
        if row["name"] in SHARD_ROWS:
            layout, key = SHARD_ROWS[row["name"]]
            row["shard_offsets"] = "PR 17"
            row["shard"] = dict(shards[layout]["ms"][key], layout=layout,
                                shards=VIRTUAL_SHARDS)
        by_leg = {leg: c[row["name"]] for leg, c in legs.items()
                  if c.get(row["name"])}
        if by_leg:
            row["launches_slice17"] = by_leg


def slice17_phase(torch, fa, ln, ok, xe, wf):
    """Phase 14 (module docstring): the card as a torch.distributed NCCL
    process group of one rank (an in-process HashStore: no network, no
    file), the dp group of `parallel.mesh.initialize_model_parallel`
    stated and checked as a world of one, and the four legs through it.
    The group is torn down after."""
    import torch.distributed as dist
    from apex_tpu_torch.parallel import mesh

    t0 = time.perf_counter()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        group = mesh.initialize_model_parallel()
        check(group is not None and dist.get_backend(group) == "nccl"
              and mesh.get_data_parallel_world_size() == 1
              and mesh.get_data_parallel_rank() == 0,
              "slice 17: the dp group is not a one-rank NCCL group")
        out = {"process_group": {"backend": dist.get_backend(group),
                                 "world_size": dist.get_world_size(group)}}
        out["zero2_sweep"] = zero2_sweep_leg(torch, fa, ln, ok)
        log("slice 17 zero2 sweep " + json.dumps(out["zero2_sweep"]))
        out["microbatches"] = microbatch_leg(torch, fa, ln, ok)
        log("slice 17 microbatches " + json.dumps(out["microbatches"]))
        out["zero_lamb"] = zero_lamb_leg(torch, fa, ln, ok)
        log("slice 17 ZeRO LAMB " + json.dumps(out["zero_lamb"]))
        o2, o2_vs_plain, _ = resnet_phase(torch, xe, wf, ok, opt_level="O2")
        out["resnet_o2"] = dict(o2, vs_plain=o2_vs_plain)
        log("slice 17 ResNet-50 O2 " + json.dumps(out["resnet_o2"]))
    finally:
        mesh.destroy_model_parallel()
        dist.destroy_process_group()
    log(f"phase 14 {time.perf_counter() - t0:.1f}s")
    return out

# ------------------ slice 18: tensor and sequence parallelism ------------------

def nccl_by_kind(torch, prof):
    """The collectives a profiled run issued, by kind (the profiler's
    host-side `nccl:*` ranges, one a collective that reached NCCL); the
    device-side events named for NCCL, by name (at one rank the
    collectives' ranges on the card's timeline: a one-rank communicator
    launches no NCCL kernel); and the device-to-device copies (what a
    one-rank gather or scatter moves)."""
    calls, device = {}, {}
    dtod = 0
    for e in prof.key_averages():
        key = e.key
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if "nccl" in key.lower():
                device[key[:80]] = device.get(key[:80], 0) + e.count
            if "dtod" in key.lower():
                dtod += e.count
        elif key.startswith("nccl:"):
            k = key.lower()
            kind = ("reduce_scatter" if "scatter" in k
                    else "all_reduce" if "reduce" in k
                    else "all_gather" if "gather" in k
                    else "p2p" if ("send" in k or "recv" in k) else key)
            calls[kind] = calls.get(kind, 0) + e.count
    return {"calls": calls, "device": device, "memcpy_dtod": dtod}


def implied_collectives(layers, sequence_parallel, chunks):
    """The collectives one GPT training step through
    `make_tp_dp_train_step` issues at tp = dp = 1 on a process group, by
    kind, from the layers' spellings: all-reduces of the embedding, the
    cross entropy (max, sum-exp, target), the step's flat gradient and
    loss and, under sequence parallelism, one for the gradients of every
    LayerNorm param and row-parallel bias together
    (`copy_to_tensor_model_parallel_region_many`); without it, the LM
    head's copy_to, each row-parallel layer's forward and each
    column-parallel layer's backward.  Under sequence parallelism each
    column layer all-gathers forward and reduce-scatters backward, each
    row layer the reverse, and the positions, the embedding's scatter
    and the LM head's gather add three more; chunked, at one rank the
    ring has no hop, and each column layer's backward and each row
    layer's forward and backward issue one collective a chunk."""
    n = layers
    if not sequence_parallel:
        return {"all_reduce": 4 * n + 7}
    out = {"all_reduce": 7}
    if chunks == 1:
        out.update(all_gather=4 * n + 3, reduce_scatter=4 * n + 1)
    else:
        out.update(all_gather=2 * n * chunks + 3,
                   reduce_scatter=4 * n * chunks + 1)
    return out


def tp_gpt_leg(torch, fa, ln, ok, what, sequence_parallel, chunks, warmup,
               steps, params):
    """GPT-350M at full width (phase 5's: vocab 50304, h1024, L24, 16
    heads, seq 1024, batch 12, bf16, bf16 logits, flash, no dropout,
    seed-1 tokens) through the TP layers at `sequence_parallel` and
    `overlap_chunks=chunks`, `FusedAdam(lr=1e-4, master bf16)`,
    `make_tp_dp_train_step` on the mesh's one-rank groups: `warmup` +
    `steps` steps (phase 5's launches each), one with no host sync, one
    profiled with the collectives it issued held to
    `implied_collectives`.  `params`: the seed-0 weights (copied)."""
    from apex_tpu_torch.models import gpt as gpt_mod
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.transformer.training import (
        init_sharded_optimizer, make_tp_dp_train_step)

    bf16 = torch.bfloat16
    batch, seq = 12, 1024
    model = gpt_mod.gpt_350m(
        vocab_size=50304, seq_len=seq, dropout=0.0, dtype=bf16,
        logits_dtype=bf16, use_flash_attention=True,
        sequence_parallel=sequence_parallel, overlap_chunks=chunks)
    opt = FusedAdam(lr=1e-4, master_dtype=bf16)
    state = init_sharded_optimizer(opt, model, params)
    step = make_tp_dp_train_step(model, opt)
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, 50304, (batch, seq), generator=gen,
                           device="cuda", dtype=torch.int32)
    labels = torch.roll(tokens, -1, dims=1)
    per_step = {"flash_attention_fwd": 24, "flash_attention_bwd": 24,
                "layer_norm_fwd": 49, "layer_norm_bwd": 49, "adam": 1}
    state, res = train_loop(torch, fa, ln, ok, what, step, state,
                            (tokens, labels), per_step, warmup, steps)
    state, syncs = step_without_sync(torch, step, state, tokens, labels)
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, tokens, labels)
        torch.cuda.synchronize()
    kernels = device_time_by_kernel(torch, prof)
    nccl = nccl_by_kind(torch, prof)
    want = implied_collectives(model.c.num_layers, sequence_parallel,
                               chunks)
    check(nccl["calls"] == want, f"{what}: the step issued the collectives "
          f"{nccl}, the layers imply {want}")
    device_ms = sum(kernels.values()) / 1e3
    del state, opt, step
    torch.cuda.empty_cache()
    return dict(res, config=f"GPT-350M bf16, batch 12 x seq 1024, bf16 "
                f"logits, flash, sequence_parallel={sequence_parallel}, "
                f"overlap_chunks={chunks}, FusedAdam(lr=1e-4, master bf16), "
                f"make_tp_dp_train_step on one-rank NCCL tp and dp groups",
                tokens_per_s=batch * seq * steps / res["window_s"],
                host_syncs_per_step=len(syncs), device_ms=device_ms,
                nccl_per_step=nccl, implied_collectives=want)


def tp_three_steps(torch, params, chunks, sequence_parallel=True):
    """Three steps of the leg's model at `chunks` from `params`: the
    leaves before and after, and the losses."""
    from apex_tpu_torch.models import gpt as gpt_mod
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.optimizers import flat as F
    from apex_tpu_torch.transformer.training import (
        init_sharded_optimizer, make_tp_dp_train_step)

    bf16 = torch.bfloat16
    model = gpt_mod.gpt_350m(
        vocab_size=50304, seq_len=1024, dropout=0.0, dtype=bf16,
        logits_dtype=bf16, use_flash_attention=True,
        sequence_parallel=sequence_parallel, overlap_chunks=chunks)
    opt = FusedAdam(lr=1e-4, master_dtype=bf16)
    state = init_sharded_optimizer(opt, model, params)
    step = make_tp_dp_train_step(model, opt)
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, 50304, (12, 1024), generator=gen,
                           device="cuda", dtype=torch.int32)
    labels = torch.roll(tokens, -1, dims=1)
    losses = []
    for _ in range(3):
        state, loss = step(state, tokens, labels)
        losses.append(float(loss))
    after = [x.clone() for x in F.unflatten_leaves(state.params, opt.spec)]
    del state, opt, step
    torch.cuda.empty_cache()
    return after, losses


def overlap_leg(torch, fa, ln, ok, warmup=3, steps=20):
    """Slice 18 (a): bench.py's `_overlap_measure` (bench.py:914-975), cut
    from tp = 2 to tp = 1 by the box: GPT-350M with sequence parallelism
    at overlap_chunks 1 (the monolithic gather / reduce-scatter) and 2
    (the P2P ring, here without a hop, and the chunked reduce-scatters),
    3 + 20 steps each: step ms, tokens/s, peak GiB, the device ms and
    collectives of one profiled step, the speedup.  Gates: no host sync,
    phase 5's launches, the collectives the layers imply, first-step
    losses within 1e-3 relative, losses finite and falling, and three
    steps' update (relative L2 of chunked against monolithic) within 3x
    that of two monolithic runs (a GPT step is not bit for bit
    repeatable on the card)."""
    from apex_tpu_torch.models import gpt as gpt_mod
    from apex_tpu_torch.optimizers import flat as F

    bf16 = torch.bfloat16
    params = gpt_mod.init_gpt_params(gpt_mod.GPTConfig(
        **gpt_mod.GPT2_350M, vocab_size=50304, seq_len=1024, dtype=bf16),
        seed=0)
    out = {"cut": "bench.py's _overlap_measure runs tp = 2; the box has "
                  "one H100, so tp = 1 (one-rank NCCL tp and dp groups): "
                  "every region collective and every chunk is issued, as "
                  "a copy, and no collective is left to hide"}
    for name, chunks in (("monolithic", 1), ("chunked", 2)):
        out[name] = tp_gpt_leg(torch, fa, ln, ok, f"overlap {name}", True,
                               chunks, warmup, steps, params)
        log(f"slice 18 overlap {name} " + json.dumps(out[name]))
    mono, chunked = out["monolithic"], out["chunked"]
    out["speedup"] = mono["step_ms"] / chunked["step_ms"]
    first = abs(chunked["losses"][0] - mono["losses"][0]) / abs(
        mono["losses"][0])
    out["first_loss_rel_diff"] = first
    check(first <= 1e-3, f"overlap: first-step losses {mono['losses'][0]} "
          f"(monolithic) and {chunked['losses'][0]} (chunked)")
    a0 = [x.clone() for x in F.tree_leaves(params)]
    a, al = tp_three_steps(torch, params, 1)
    b, _ = tp_three_steps(torch, params, 1)
    z, zl = tp_three_steps(torch, params, 2)

    def dist_(u, w):
        return sum((x.float() - y.float()).norm() ** 2
                   for x, y in zip(u, w)).sqrt().item()

    upd = dist_(a, a0)
    out["three_steps"] = {
        "losses_monolithic": al, "losses_chunked": zl,
        "update_l2": upd,
        "chunked_vs_monolithic_rel_to_update": dist_(z, a) / upd,
        "monolithic_run_to_run_rel_to_update": dist_(b, a) / upd}
    t3 = out["three_steps"]
    check(t3["chunked_vs_monolithic_rel_to_update"]
          <= 3 * t3["monolithic_run_to_run_rel_to_update"],
          f"overlap: three steps chunked against monolithic {t3}")
    del a, b, z, a0, params
    torch.cuda.empty_cache()
    return out


def copy_reduce_leg(torch, fa, ln, ok, train, warmup=1, steps=3):
    """Slice 18 (b): the same model without sequence parallelism, chunks
    1: the copy / reduce path, an all-reduce per row-parallel layer
    forward and per column-parallel layer backward.  1 + 3 steps, phase
    5's launches, no host sync, the collectives the layers imply; its
    first-step loss within 1e-3 relative of phase 5's from the same
    weights and tokens."""
    from apex_tpu_torch.models import gpt as gpt_mod

    params = gpt_mod.init_gpt_params(gpt_mod.GPTConfig(
        **gpt_mod.GPT2_350M, vocab_size=50304, seq_len=1024,
        dtype=torch.bfloat16), seed=0)
    out = tp_gpt_leg(torch, fa, ln, ok, "copy/reduce", False, 1, warmup,
                     steps, params)
    del params
    rel = abs(out["losses"][0] - train["losses"][0]) / abs(
        train["losses"][0])
    out["first_loss_rel_diff_vs_phase5"] = rel
    check(rel <= 1e-3, f"copy/reduce: first-step loss {out['losses'][0]}, "
          f"phase 5's {train['losses'][0]}")
    return out


def slice18_phase(torch, fa, ln, ok, train):
    """Phase 15 (module docstring): the card as a torch.distributed NCCL
    process group of one rank (an in-process HashStore), the tp and dp
    groups of `initialize_model_parallel(tensor_model_parallel_size=1)`
    checked as one-rank NCCL groups, legs (a) and (b) through them; the
    groups torn down after."""
    import torch.distributed as dist
    from apex_tpu_torch.parallel import mesh

    t0 = time.perf_counter()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        mesh.initialize_model_parallel(tensor_model_parallel_size=1)
        groups = {"tp": mesh.get_tensor_model_parallel_group(),
                  "dp": mesh.get_data_parallel_group()}
        check(all(g is not None and dist.get_backend(g) == "nccl"
                  and dist.get_world_size(g) == 1 for g in groups.values()),
              "slice 18: the tp and dp groups are not one-rank NCCL groups")
        out = {"process_groups": {k: {"backend": dist.get_backend(g),
                                      "world_size": dist.get_world_size(g)}
                                  for k, g in groups.items()}}
        out["overlap"] = overlap_leg(torch, fa, ln, ok)
        log("slice 18 overlap " + json.dumps(
            {k: v for k, v in out["overlap"].items()
             if k not in ("monolithic", "chunked")}))
        out["copy_reduce"] = copy_reduce_leg(torch, fa, ln, ok, train)
        log("slice 18 copy/reduce " + json.dumps(out["copy_reduce"]))
    finally:
        mesh.destroy_model_parallel()
        dist.destroy_process_group()
    log(f"phase 15 {time.perf_counter() - t0:.1f}s")
    return out


# ------------------ slice 19: pipeline parallelism ------------------------------

SLICE19_ROWS = ("flash_attention_fwd", "flash_attention_bwd",
                "layer_norm_fwd", "layer_norm_bwd", "adam")


def implied_pipeline_collectives(layers, microbatches, window, fused_xent):
    """The all-reduces one `GPTPipelined` step through
    `make_tp_dp_train_step` issues at pp = tp = dp = 1 on one-rank
    groups (no sequence parallelism): per microbatch phase 15's copy /
    reduce path (each row-parallel layer's forward, each column-parallel
    layer's backward, the embedding, the cross entropy's three, the LM
    head's copy_to), then the step's flat gradient and loss over dp and,
    over pp, the loss's broadcast from the last stage and the sum of the
    replicated leaves' gradients (`pp_partial_grads=True`).  Under a
    checkpoint window the backward recomputes each clock's stage
    forward, which issues its row-parallel all-reduces again, and each
    microbatch's head: the fused cross entropy (one autograd op) issues
    its three again, the unfused one two, as the recompute stops once
    the tensors its backward saved are back (torch.utils.checkpoint's
    early stop), before the loss's last all-reduce.  A hop over a
    one-rank pp group is a copy: no p2p call."""
    n, m = layers, microbatches
    count = m * (4 * n + 5) + 4
    if window:
        count += m * (2 * n + (3 if fused_xent else 2))
    return {"all_reduce": count}


def pipelined_gpt_leg(torch, fa, ln, ok, window, params, tokens, labels,
                      warmup=1, steps=3):
    """Slice 19 (a) at `checkpoint_window=window`: GPT-350M (phase 5's
    config) as `GPTPipelined(pp=1)`, 4 microbatches of 3, through
    `make_tp_dp_train_step` on the mesh's one-rank groups: `warmup` +
    `steps` steps with the launches the schedule implies, one step with
    no host sync, one profiled: wall and device ms and the collectives
    (held to `implied_pipeline_collectives`)."""
    from apex_tpu_torch.models import gpt as gpt_mod
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.transformer.training import (
        init_sharded_optimizer, make_tp_dp_train_step)
    from torch.profiler import ProfilerActivity, profile

    bf16 = torch.bfloat16
    m, L = 4, 24
    model = gpt_mod.GPTPipelined(
        gpt_mod.GPTConfig(**gpt_mod.GPT2_350M, vocab_size=50304,
                          seq_len=1024, dropout=0.0, dtype=bf16,
                          logits_dtype=bf16, use_flash_attention=True),
        num_microbatches=m, pipeline_parallel_size=1,
        checkpoint_window=window)
    opt = FusedAdam(lr=1e-4, master_dtype=bf16)
    state = init_sharded_optimizer(opt, model, model.stack(params))
    # the train step's pp path too: at one rank its sum is an identity
    step = make_tp_dp_train_step(model, opt, pp_partial_grads=True)
    # one clock per microbatch at pp = 1; a window recomputes each
    # clock's 24 blocks (and each microbatch's final LayerNorm) once more
    again = 2 if window else 1
    per_step = {"flash_attention_fwd": L * m * again,
                "flash_attention_bwd": L * m,
                "layer_norm_fwd": (2 * L + 1) * m * again,
                "layer_norm_bwd": (2 * L + 1) * m, "adam": 1}
    what = f"GPTPipelined checkpoint_window={window}"
    state, res = train_loop(torch, fa, ln, ok, what, step, state,
                            (tokens, labels), per_step, warmup, steps)
    state, syncs = step_without_sync(torch, step, state, tokens, labels)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        state, _ = step(state, tokens, labels)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t1)
    device_ms = sum(device_time_by_kernel(torch, prof).values()) / 1e3
    nccl = nccl_by_kind(torch, prof)
    want = implied_pipeline_collectives(L, m, window, fused_xent=True)
    check(nccl["calls"] == want, f"{what}: the step issued {nccl}, the "
          f"schedule implies {want}")
    del state, opt, step
    torch.cuda.empty_cache()
    return dict(res, config=f"GPT-350M bf16, 4 microbatches of 3 x seq "
                f"1024, bf16 logits, flash, GPTPipelined(pp=1, "
                f"checkpoint_window={window}), FusedAdam(lr=1e-4, master "
                f"bf16), make_tp_dp_train_step on one-rank NCCL groups",
                tokens_per_s=12 * 1024 * steps / res["window_s"],
                host_syncs_per_step=len(syncs), profiled_wall_ms=wall_ms,
                device_ms=device_ms, device_busy_share=device_ms / wall_ms,
                nccl_per_step=nccl, implied_collectives=want,
                hops_over_nccl=nccl["calls"].get("p2p", 0))


def gpt_stage_fns(torch, model, cuts):
    """GPT-350M cut into host-pipeline stages at the block indices
    `cuts` (stage i runs blocks cuts[i]..cuts[i+1]-1): stage 0 embeds
    the (1, S) tokens and makes the labels, the stages pass (h, labels),
    the last ends with the final LayerNorm, the tied LM head and the
    mean cross entropy.  Returns (apply functions, a function giving
    each stage's params from a GPT tree); the embedding sits on the
    first and the last stage."""
    from apex_tpu_torch.ops.layer_norm import fused_layer_norm
    from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (
        vocab_parallel_cross_entropy)

    n = len(cuts) - 1

    def blocks(i, p, h):
        for b in range(cuts[i], cuts[i + 1]):
            h = model._block(b, p[f"block{b}"], h)
        return h

    def first(p, tokens):
        h = model.embed.apply(p["embed"], tokens.T)
        h = h + p["pos_embed"][:tokens.shape[1]][:, None, :].to(h.dtype)
        return blocks(0, p, h), torch.roll(tokens, -1, dims=1).T

    def middle(i):
        def fn(p, x):
            h, lab = x
            return blocks(i, p, h), lab
        return fn

    def last(p, x):
        h, lab = x
        h = blocks(n - 1, p, h)
        h = fused_layer_norm(h, p["final_ln"]["weight"], p["final_ln"]["bias"])
        return torch.mean(vocab_parallel_cross_entropy(
            model.logits_local(p, h), lab, fused=model.c.fused_xent))

    fns = [first] + [middle(i) for i in range(1, n - 1)] + [last]

    def stage_params(tree):
        out = []
        for i in range(n):
            p = {f"block{b}": tree[f"block{b}"]
                 for b in range(cuts[i], cuts[i + 1])}
            if i == 0:
                p.update(embed=tree["embed"], pos_embed=tree["pos_embed"])
            if i == n - 1:
                p.update(embed=tree["embed"], final_ln=tree["final_ln"])
            out.append(p)
        return out

    return fns, stage_params


def rel_l2(torch, got, want):
    """|got - want| / |want| over lists of tensors, in fp32."""
    num = sum((g.float() - w.float()).norm() ** 2 for g, w in zip(got, want))
    den = sum(w.float().norm() ** 2 for w in want)
    return (num / den).sqrt().item()


def host_pipeline_leg(torch, fa, ln, ok, params, warmup=1, steps=3):
    """Slice 19 (b): `host_pipeline_train_step` over GPT-350M (bf16,
    flash, bf16 logits) cut into 4 `HostPipelineStage`s of 6 blocks on
    cuda:0, 8 microbatches of (1, 1024), schedules "1f1b" and "gpipe",
    `warmup` + `steps` steps each (no process group: the stages share
    one card).  Gates: the launches a step the schedule implies, the
    in-flight peaks (the 1F1B bound, gpipe all 8), 1f1b's peak memory
    below gpipe's; the mean loss within 2e-3 and each stage's gradients
    within 1e-2 relative L2 of one-program autograd through the same
    stages, and the tied embedding's two partial gradients summed."""
    from apex_tpu_torch.models import gpt as gpt_mod
    from apex_tpu_torch.optimizers import flat as F
    from apex_tpu_torch.transformer.pipeline_parallel import (
        HostPipelineStage, host_pipeline_train_step)
    from torch.profiler import ProfilerActivity, profile

    bf16 = torch.bfloat16
    model = gpt_mod.gpt_350m(vocab_size=50304, seq_len=1024, dropout=0.0,
                             dtype=bf16, logits_dtype=bf16,
                             use_flash_attention=True)
    fns, stage_params = gpt_stage_fns(torch, model, [0, 6, 12, 18, 24])
    plist = stage_params(params)
    stages = [HostPipelineStage(f) for f in fns]
    gen = torch.Generator(device="cuda").manual_seed(2)
    mbs = [torch.randint(0, 50304, (1, 1024), generator=gen, device="cuda",
                         dtype=torch.int32) for _ in range(8)]
    # one-program autograd through the same stages, a microbatch at a
    # time, the gradients summed in fp32
    specs = [F.make_spec(p) for p in plist]
    leaves = [[x.detach().requires_grad_() for x in F.tree_leaves(p)]
              for p in plist]
    trees = [F.tree_from_leaves(sp, lv) for sp, lv in zip(specs, leaves)]
    ref = [[torch.zeros_like(x, dtype=torch.float32) for x in lv]
           for lv in leaves]
    ref_loss = 0.0
    for x in mbs:
        h = x
        for f, p in zip(fns, trees):
            h = f(p, h)
        loss = h / len(mbs)
        gs = iter(torch.autograd.grad(loss, [x_ for lv in leaves
                                             for x_ in lv]))
        for acc in ref:
            for a in acc:
                a += next(gs).float()
        ref_loss += float(loss.detach())
    del leaves, trees, h, loss
    ref_trees = [F.tree_from_leaves(sp, r) for sp, r in zip(specs, ref)]
    ref_tied = [ref_trees[0]["embed"]["weight"]
                + ref_trees[-1]["embed"]["weight"]]
    torch.cuda.empty_cache()
    per_step = {"flash_attention_fwd": 8 * (3 * 2 * 6 + 6),
                "flash_attention_bwd": 8 * 24,
                "layer_norm_fwd": 8 * (3 * 2 * 12 + 13),
                "layer_norm_bwd": 8 * 49}
    out = {"config": "GPT-350M bf16 (bf16 logits, flash) cut into 4 "
                     "HostPipelineStages of 6 blocks on cuda:0, 8 "
                     "microbatches of (1, 1024)",
           "reference_loss": ref_loss}
    for schedule in ("1f1b", "gpipe"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_kernel_counts(fa, ln, ok)
        losses = []
        t0 = time.perf_counter()
        for i in range(warmup + steps):
            if i == warmup:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            loss, grads, stats = host_pipeline_train_step(
                stages, plist, mbs, schedule=schedule, return_stats=True)
            losses.append(loss)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        counts = kernel_counts(fa, ln, ok)
        for name, n_ in per_step.items():
            check(counts[name] == n_ * (warmup + steps),
                  f"host pipeline {schedule} {name}: {counts[name]} "
                  f"launches in {warmup + steps} steps, want {n_} a step")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            host_pipeline_train_step(stages, plist, mbs, schedule=schedule)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t1)
        device_ms = sum(device_time_by_kernel(torch, prof).values()) / 1e3
        losses = [float(x) for x in losses]
        rel = abs(losses[-1] - ref_loss) / abs(ref_loss)
        check(rel <= 2e-3, f"host pipeline {schedule}: loss {losses[-1]} "
              f"against one-program autograd's {ref_loss}")
        gaps = [rel_l2(torch, F.tree_leaves(g), F.tree_leaves(r))
                for g, r in zip(grads, ref_trees)]
        tied = rel_l2(torch, [grads[0]["embed"]["weight"].float()
                              + grads[-1]["embed"]["weight"].float()],
                      ref_tied)
        check(max(gaps) <= 1e-2 and tied <= 1e-2,
              f"host pipeline {schedule}: stage gradients' relative L2 "
              f"gaps {gaps}, the tied embedding's {tied}")
        peaks = stats["peak_in_flight_per_stage"]
        if schedule == "1f1b":
            check(all(p <= 4 - i for i, p in enumerate(peaks))
                  and peaks[-1] == 1, f"1f1b in-flight peaks {peaks}")
        else:
            check(peaks == [8] * 4, f"gpipe in-flight peaks {peaks}")
        out[schedule] = {
            "losses": losses, "loss_rel_diff": rel,
            "grad_rel_l2_by_stage": gaps, "tied_embedding_rel_l2": tied,
            "peak_in_flight_per_stage": peaks, "peak_mem_gib": peak,
            "step_ms": 1e3 * window_s / steps,
            "tokens_per_s": 8 * 1024 * steps / window_s,
            "profiled_wall_ms": wall_ms, "device_ms": device_ms,
            "device_busy_share": device_ms / wall_ms,
            "launches": {k_: counts[k_] for k_ in per_step},
            "launches_per_step": per_step}
        del grads
        torch.cuda.empty_cache()
    check(out["1f1b"]["peak_mem_gib"] < out["gpipe"]["peak_mem_gib"],
          f"1f1b's peak {out['1f1b']['peak_mem_gib']} GiB is not below "
          f"gpipe's {out['gpipe']['peak_mem_gib']}")
    del ref, ref_trees, ref_tied, plist, stages
    torch.cuda.empty_cache()
    return out


def add_slice19_columns(rows, slice19):
    """The kernel table's slice-19 column: on every row a phase-16 leg
    launched, its launches by leg."""
    legs = {f"pipelined window={w}": slice19["pipelined"][w]["launches"]
            for w in slice19["pipelined"]}
    for schedule in ("1f1b", "gpipe"):
        legs[f"host {schedule}"] = slice19["host"][schedule]["launches"]
    for row in rows:
        by_leg = {leg: c[row["name"]] for leg, c in legs.items()
                  if c.get(row["name"])}
        if row["name"] in SLICE19_ROWS and by_leg:
            row["launches_slice19"] = by_leg


def slice19_phase(torch, fa, ln, ok):
    """Phase 16 (module docstring): (a) on the card as a one-rank NCCL
    group, the pp, tp and dp groups of `initialize_model_parallel(
    pipeline_model_parallel_size=1)` checked as one-rank NCCL groups,
    GPTPipelined at checkpoint_window None and 1 (first-step losses
    within 2e-3 of the plain `GPT.loss` on the same weights and tokens,
    and equal to each other); (b) with no process group, the host
    pipeline over GPT-350M in four stages."""
    import torch.distributed as dist
    from apex_tpu_torch.models import gpt as gpt_mod
    from apex_tpu_torch.parallel import mesh

    t0 = time.perf_counter()
    bf16 = torch.bfloat16
    cfg = gpt_mod.GPTConfig(**gpt_mod.GPT2_350M, vocab_size=50304,
                            seq_len=1024, dropout=0.0, dtype=bf16,
                            logits_dtype=bf16, use_flash_attention=True)
    params = gpt_mod.init_gpt_params(cfg, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, 50304, (12, 1024), generator=gen,
                           device="cuda", dtype=torch.int32)
    labels = torch.roll(tokens, -1, dims=1)
    with torch.no_grad():
        plain = float(gpt_mod.GPT(cfg).loss(params, tokens, labels))
    out = {"plain_first_loss": plain, "pipelined": {}}
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        mesh.initialize_model_parallel(pipeline_model_parallel_size=1)
        groups = {"pp": mesh.get_pipeline_model_parallel_group(),
                  "tp": mesh.get_tensor_model_parallel_group(),
                  "dp": mesh.get_data_parallel_group()}
        check(all(g is not None and dist.get_backend(g) == "nccl"
                  and dist.get_world_size(g) == 1 for g in groups.values()),
              "slice 19: the pp, tp and dp groups are not one-rank NCCL "
              "groups")
        for window in (None, 1):
            leg = pipelined_gpt_leg(torch, fa, ln, ok, window, params,
                                    tokens, labels)
            rel = abs(leg["losses"][0] - plain) / abs(plain)
            leg["first_loss_rel_diff_vs_plain"] = rel
            check(rel <= 2e-3, f"GPTPipelined window={window}: first loss "
                  f"{leg['losses'][0]}, plain GPT.loss {plain}")
            out["pipelined"][window] = leg
            log(f"slice 19 GPTPipelined checkpoint_window={window} "
                + json.dumps(leg))
    finally:
        mesh.destroy_model_parallel()
        dist.destroy_process_group()
    a, b = (out["pipelined"][w]["losses"][0] for w in (None, 1))
    check(a == b, f"GPTPipelined: first-step losses at window None {a} and "
          f"1 {b} differ")
    out["host"] = host_pipeline_leg(torch, fa, ln, ok, params)
    log("slice 19 host pipeline " + json.dumps(out["host"]))
    del params
    torch.cuda.empty_cache()
    log(f"phase 16 {time.perf_counter() - t0:.1f}s")
    return out


# ------------------ slice 20: context parallelism ------------------------------
#
# Ring attention and Ulysses (apex_tpu_torch/parallel/context_parallel.py)
# over the flash kernels' chunk entry points, whose backward kernels write
# fp32 gradients for the ring (the F32 instantiations).

RING_CHUNK_SHAPES = ((1, 8, 4096, 64), (1, 8, 8192, 64), (1, 8, 16384, 64))
VIRTUAL_RANKS = 4
CP_SEED = 0x5EED20               # the phase-17 legs' dropout seed


def f32_twin(name):
    """The bf16 twin of an F32 instantiation's mangled name
    (flash_bwd_kernel<D, SEG, DQ, F32, DROP>, flash_bwd_dq_kernel<D, SEG,
    F32, DROP>: the argument before the last, `Lb1E`, set to `Lb0E`), or
    None if `name` is not one."""
    m = re.match(r"(.*(?:flash_bwd_kernel|flash_bwd_dq_kernel)I"
                 r"(?:L[ib]\d+E)*)Lb1E(Lb[01]EE.*)", name)
    return None if m is None else f"{m.group(1)}Lb0E{m.group(2)}"


def check_f32_ptxas(log_text):
    """Phase 1's gate on the fp32-output instantiations: each has no
    spill and no serialised-wgmma note that its bf16 twin lacks.  Returns
    their registers by kernel, beside the twin's."""
    rows, notes = flash_ptxas(log_text)
    out = {}
    for name, r in rows.items():
        twin = f32_twin(name)
        if twin is None or twin not in rows:
            continue
        check(r.get("spills", "").startswith(
            "0 bytes stack frame, 0 bytes spill"),
            f"fp32 instantiation {name} spills: {r}")
        new = set(notes.get(name, [])) - set(notes.get(twin, []))
        check(not new, f"fp32 instantiation {name}: serialised-wgmma notes "
              f"{sorted(new)} that its bf16 twin lacks")
        out[name] = (r.get("registers"), rows[twin].get("registers"))
    check(len(out) == 24, f"{len(out)} fp32 instantiations, want 24")
    return out


def check_f32_grads(torch, fa, rng, *, b, h, sq, sk, d, causal, q_seg=None,
                    kv_seg=None, rate=0.0, offs=(0, 0)):
    """The backward kernels with fp32 outputs (`out_dtype=torch.float32`)
    on one bf16 input: the fused kernel's dk, dv and the dk/dv pass's are
    the bf16 launches' before the rounding (rounded to bf16 they equal
    them bit for bit), and so is the dq pass's dq; each fp32 launch twice
    gives the same bits (the fused kernel's dq, summed by reduce-adds in
    an order that varies, within the tolerance); the dk/dv pass's fp32
    dk, dv equal the fused kernel's; every fp32 output against the plain
    versions with fp32 outputs within 1e-2 of its largest magnitude.
    `rate` > 0: dropout under (CP_SEED, *offs).  Returns the errors."""
    dev, bf16, f32 = "cuda", torch.bfloat16, torch.float32
    q, do = (torch.randn((b, h, sq, d), generator=rng, device=dev).to(bf16)
             for _ in range(2))
    k, v = (torch.randn((b, h, sk, d), generator=rng, device=dev).to(bf16)
            for _ in range(2))
    sc = 1.0 / math.sqrt(d)
    kw = dict(dropout_rate=rate, seed=(CP_SEED, *offs)) if rate else {}
    o, lse = fa.flash_fwd_cuda(q, k, v, sc, causal, q_seg, kv_seg, **kw)
    delta = torch.sum(do.float() * o.float(), dim=-1)
    args = (q, k, v, do, lse, delta, sc, causal, q_seg, kv_seg)
    _, fdk16, fdv16 = fa.flash_bwd_cuda(*args, **kw)
    fdq, fdk, fdv = fa.flash_bwd_cuda(*args, **kw, out_dtype=f32)
    fdq2, fdk2, fdv2 = fa.flash_bwd_cuda(*args, **kw, out_dtype=f32)
    sdq16 = fa.flash_bwd_dq_cuda(*args, **kw)
    sdq = fa.flash_bwd_dq_cuda(*args, **kw, out_dtype=f32)
    sdq2 = fa.flash_bwd_dq_cuda(*args, **kw, out_dtype=f32)
    sdk16, sdv16 = fa.flash_bwd_dkv_cuda(*args, **kw)
    sdk, sdv = fa.flash_bwd_dkv_cuda(*args, **kw, out_dtype=f32)
    sdk2, sdv2 = fa.flash_bwd_dkv_cuda(*args, **kw, out_dtype=f32)
    pkw = dict(kw, out_dtype=f32)
    pdq = fa.flash_bwd_dq_reference(*args, **pkw)
    pdk, pdv = fa.flash_bwd_dkv_reference(*args, **pkw)
    torch.cuda.synchronize()
    case = (f"fp32 grads ({b},{h},{sq},{sk},{d}) causal={causal} "
            f"ids={q_seg is not None} rate={rate} offs={offs}")
    check(all(t.dtype == f32 for t in (fdq, fdk, fdv, sdq, sdk, sdv)),
          f"{case}: an output is not fp32")
    for name, t32, t16 in (("fused dk", fdk, fdk16), ("fused dv", fdv, fdv16),
                           ("dq pass dq", sdq, sdq16),
                           ("dk/dv pass dk", sdk, sdk16),
                           ("dk/dv pass dv", sdv, sdv16)):
        check(torch.equal(t32.to(bf16), t16),
              f"{case}: {name} rounded to bf16 is not the bf16 launch's")
    for name, a, b_ in (("fused dk", fdk, fdk2), ("fused dv", fdv, fdv2),
                        ("dq pass dq", sdq, sdq2), ("dk/dv pass dk", sdk, sdk2),
                        ("dk/dv pass dv", sdv, sdv2),
                        ("dk/dv pass dk vs fused", sdk, fdk),
                        ("dk/dv pass dv vs fused", sdv, fdv)):
        check(torch.equal(a, b_), f"{case}: {name}: two launches differ")
    return {"fused_dq": max_err(torch, f"{case} fused dq", fdq, pdq),
            "fused_dq_twice": max_err(torch, f"{case} fused dq twice", fdq2,
                                      fdq),
            "dq_pass": max_err(torch, f"{case} dq pass", sdq, pdq),
            "dk": max_err(torch, f"{case} dk", fdk, pdk),
            "dv": max_err(torch, f"{case} dv", fdv, pdv)}


def f32_checks(torch, fa, rng):
    """Phase 2's fp32-output checks (module docstring): the ring's chunk
    shapes causal and not, sq != sk off the tile, head_dim 128 with
    padding and a dead row, dropout 0.1 at offsets 8192 / 4096."""
    out = {}
    for b, h, s, d in RING_CHUNK_SHAPES:
        for causal in (True, False):
            out[f"({b},{h},{s},{d}) causal={causal}"] = check_f32_grads(
                torch, fa, rng, b=b, h=h, sq=s, sk=s, d=d, causal=causal)
            torch.cuda.empty_cache()
    for b, h, sq, sk, d, causal in ((2, 4, 100, 300, 64, True),
                                    (1, 4, 330, 129, 128, False)):
        out[f"sq={sq} sk={sk} d={d} causal={causal}"] = check_f32_grads(
            torch, fa, rng, b=b, h=h, sq=sq, sk=sk, d=d, causal=causal)
    sg = pad_segments(torch, 4, BERT_SEQ, [512, 300, 129, 1])
    qd = sg.clone()
    qd[1, 400] = 5                      # a query whose id no key carries
    out["d=128 padding, a dead row"] = check_f32_grads(
        torch, fa, rng, b=4, h=8, sq=BERT_SEQ, sk=BERT_SEQ, d=128,
        causal=False, q_seg=qd, kv_seg=sg)
    for b, h, s, d in RING_CHUNK_SHAPES[:2]:
        out[f"({b},{h},{s},{d}) dropout 0.1 offs 8192/4096"] = (
            check_f32_grads(torch, fa, rng, b=b, h=h, sq=s, sk=s, d=d,
                            causal=False, rate=0.1, offs=(8192, 4096)))
    torch.cuda.empty_cache()
    return out


def f32_kernel_times(torch, fa, rng):
    """The backward kernels at the ring's chunk shapes, bf16 and fp32
    outputs timed in turns (CUDA events, warm L2): the fused kernel at
    4096 keys, the dq pass and the dk/dv pass at 8192 and 16384, causal
    (the diagonal chunk) and not (a full one).  Bounds: q, k, v, do read
    once in bf16, lse and delta in fp32, the outputs written once in
    their dtype (fp32: dk and dv double; the fused kernel's dq is fp32
    either way), against the products' flop (fused 5, dq pass 3, dk/dv
    pass 4 products of 2d a visible score pair) at the bf16 peak."""
    out = {}
    for (b, h, s, d), kernels in zip(RING_CHUNK_SHAPES, (
            ("fused",), ("dq", "dkv"), ("dq", "dkv"))):
        q, k, v, do = (torch.randn((b, h, s, d), generator=rng,
                                   device="cuda").to(torch.bfloat16)
                       for _ in range(4))
        sc = 1.0 / math.sqrt(d)
        io = b * h * s * d * 2
        for causal in (True, False):
            o, lse = fa.flash_fwd_cuda(q, k, v, sc, causal)
            delta = torch.sum(do.float() * o.float(), dim=-1)
            args = (q, k, v, do, lse, delta, sc, causal)
            pairs = b * h * s * (s + 1) // 2 if causal else b * h * s * s
            n = 20 if s > 4096 else 60
            for kern in kernels:
                fn, products, outs16, outs32 = {
                    "fused": (fa.flash_bwd_cuda, 5, 2 * io + 2 * io,
                              2 * io + 4 * io),
                    "dq": (fa.flash_bwd_dq_cuda, 3, io, 2 * io),
                    "dkv": (fa.flash_bwd_dkv_cuda, 4, 2 * io, 4 * io)}[kern]
                t16 = time_ms(torch, lambda: fn(*args), n=n)
                t32 = time_ms(torch, lambda: fn(*args,
                                                out_dtype=torch.float32),
                              n=n)
                t16b = time_ms(torch, lambda: fn(*args), n=n)
                t32b = time_ms(torch, lambda: fn(*args,
                                                 out_dtype=torch.float32),
                               n=n)
                ins = 4 * io + 2 * b * h * s * 4
                flop = 2 * products * d * pairs
                out[f"{kern} ({b},{h},{s},{d}) causal={causal}"] = {
                    "bf16_ms": min(t16, t16b), "f32_ms": min(t32, t32b),
                    "bf16_runs_ms": [t16, t16b], "f32_runs_ms": [t32, t32b],
                    "f32_bound_ms": 1e3 * max((ins + outs32) / HBM_BYTES_PER_S,
                                              flop / BF16_FLOPS),
                    "bf16_bound_ms": 1e3 * max(
                        (ins + outs16) / HBM_BYTES_PER_S, flop / BF16_FLOPS),
                    "bound_by": ("bytes" if (ins + outs32) / HBM_BYTES_PER_S
                                 >= flop / BF16_FLOPS else "operations")}
            del o, lse, delta, args
        del q, k, v, do
        torch.cuda.empty_cache()
    return out


def ring_leg(torch, fa, ln, ok, what, fn, qkv, per_iter, warmup=1, iters=5):
    """The gradient of fn(q, k, v).float().mean() through autograd,
    `warmup` + `iters` timed iterations from zeroed launch counts, each
    count `per_iter` times the iterations.  Returns ((o, dq, dk, dv) of
    the last iteration, the measurements)."""
    q, k, v = qkv
    s = q.shape[0] * q.shape[2]

    def grad():
        o = fn(q, k, v)
        return (o.detach(),) + torch.autograd.grad(o.float().mean(),
                                                   (q, k, v))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts(fa, ln, ok)
    for _ in range(warmup):
        out = grad()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = grad()
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    counts = kernel_counts(fa, ln, ok)
    n = warmup + iters
    for name, want in per_iter.items():
        check(counts[name] == want * n, f"{what}: {name} {counts[name]} "
              f"launches in {n} iterations, want {want} each")
    check(all(bool(torch.isfinite(t).all()) for t in out),
          f"{what}: an output or gradient is not finite")
    return out, {"warmup": warmup, "iters": iters, "ms": 1e3 * dt,
                 "tokens_per_s": s / dt,
                 "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                 "launches": {k_: counts[k_] for k_ in per_iter},
                 "launches_per_iter": per_iter}


def _per_iter(fwd=0, fused=0, dq=0, dkv=0, f32=False, drop=False):
    counts = {"flash_attention_fwd": fwd, "flash_attention_bwd": fused,
              "flash_attention_bwd_dq": dq, "flash_attention_bwd_dkv": dkv,
              "flash_attention_bwd_f32": fused if f32 else 0,
              "flash_attention_bwd_dq_f32": dq if f32 else 0,
              "flash_attention_bwd_dkv_f32": dkv if f32 else 0,
              "flash_attention_fwd_packed": 0,
              "flash_attention_bwd_packed": 0}
    if drop:
        counts.update({"flash_attention_fwd_dropout": fwd,
                       "flash_attention_bwd_dropout": fused,
                       "flash_attention_bwd_dq_dropout": dq,
                       "flash_attention_bwd_dkv_dropout": dkv})
    return counts


def one_rank_ring_legs(torch, fa, ln, ok, rng, cp, group, phase9_ms):
    """Slice 20 (a): bench.py's 32k shape (LONG_SHAPE, bf16, causal) on
    the one-rank NCCL group: flash_attention (phase 9's leg, for the
    comparison in this call), the contiguous ring, the zigzag ring and
    Ulysses, each as grad(mean(o)), 1 + 5 iterations.  The contiguous
    ring at n = 1 is flash_attention bit for bit (o and the three
    gradients: one chunk merged into the empty state, the split pair with
    fp32 outputs rounded once); zigzag and Ulysses within 1e-2 of each
    tensor's largest magnitude.  Launches an iteration: contiguous one
    forward, one dq pass and one dk/dv pass, both fp32; zigzag three of
    each (the three half-chunk pairs of its one step: (b, c) full, (a, c)
    and (b, d) diagonal), the backward's fp32; Ulysses flash_attention's."""
    q, k, v = (torch.randn(LONG_SHAPE, generator=rng, device="cuda")
               .to(torch.bfloat16).requires_grad_(True) for _ in range(3))
    legs = {}
    want, legs["flash_attention"] = ring_leg(
        torch, fa, ln, ok, "32k flash_attention",
        lambda q, k, v: fa.flash_attention(q, k, v, causal=True), (q, k, v),
        _per_iter(fwd=1, dq=1, dkv=1))
    got, legs["ring_contiguous"] = ring_leg(
        torch, fa, ln, ok, "32k ring contiguous n=1",
        lambda q, k, v: cp.ring_attention(q, k, v, group, causal=True),
        (q, k, v), _per_iter(fwd=1, dq=1, dkv=1, f32=True))
    for name, a, b_ in zip(("o", "dq", "dk", "dv"), got, want):
        check(torch.equal(a, b_), f"32k ring contiguous n=1: {name} is not "
              f"flash_attention's bit for bit")
    legs["ring_contiguous"]["equal_flash_attention_bitwise"] = True
    del got
    got, legs["ring_zigzag"] = ring_leg(
        torch, fa, ln, ok, "32k ring zigzag n=1",
        lambda q, k, v: cp.ring_attention(q, k, v, group, causal=True,
                                          layout="zigzag"),
        (q, k, v), _per_iter(fwd=3, dq=3, dkv=3, f32=True))
    legs["ring_zigzag"]["max_err_vs_flash_attention"] = {
        name: max_err(torch, f"32k ring zigzag n=1 {name}", a, b_)
        for name, a, b_ in zip(("o", "dq", "dk", "dv"), got, want)}
    del got
    got, legs["ulysses"] = ring_leg(
        torch, fa, ln, ok, "32k ulysses n=1",
        lambda q, k, v: cp.ulysses_attention(q, k, v, group, causal=True),
        (q, k, v), _per_iter(fwd=1, dq=1, dkv=1))
    legs["ulysses"]["max_err_vs_flash_attention"] = {
        name: max_err(torch, f"32k ulysses n=1 {name}", a, b_)
        for name, a, b_ in zip(("o", "dq", "dk", "dv"), got, want)}
    del got, want, q, k, v
    for leg in legs.values():
        leg["phase9_leg_ms"] = phase9_ms
    torch.cuda.empty_cache()
    return legs


def virtual_ring_leg(torch, fa, ln, ok, cp, layout, rate, qkvd):
    """Slice 20 (b) for one layout and rate: `emulate_ring` over
    VIRTUAL_RANKS shards of the 32k inputs (the ring's step functions on
    one card), causal, with dropout under CP_SEED at `rate`: o and the
    gradients against single-device flash attention (`_FlashFn`, the
    same seed) over the gathered sequence within 1e-2 of each tensor's
    largest magnitude; each rank's launches as the schedule implies
    (contiguous rank r: r + 1 chunk forwards and backwards, the split
    pair at 8192 keys; zigzag: 2n + 1 half-chunk forwards and backwards a
    rank, the fused kernel at 4096 keys; the backward's fp32, skipped
    chunks launching nothing); with dropout, each kernel's mask read back
    at every chunk offset pair the schedule ran (`check_dropout_mask`).
    Timed (wall, forward and backward of all the ranks in turn) after
    one untimed run."""
    n = VIRTUAL_RANKS
    q, k, v, do = qkvd
    sc = 1.0 / math.sqrt(q.shape[3])
    zz = layout == "zigzag"
    shards = [[t.contiguous() for t in (cp.zigzag_shard(x, n) if zz else x)
               .chunk(n, dim=2)] for x in (q, k, v, do)]
    by_rank = {("fwd", r): {} for r in range(n)}
    by_rank.update({("bwd", r): {} for r in range(n)})
    last = [kernel_counts(fa, ln, ok)]

    def after(stage, step, rank):
        now = kernel_counts(fa, ln, ok)
        acc = by_rank[(stage, rank)]
        for key, c in now.items():
            if c != last[0][key]:
                acc[key] = acc.get(key, 0) + c - last[0][key]
        last[0] = now

    offsets = set()
    chunk_fwd = cp._chunk_fwd

    def recording_fwd(q, k, v, scale, causal, q_seg, kv_seg, block_q,
                      block_k, dropout_rate=0.0, seed=None, q_off=0,
                      k_off=0):
        offsets.add((q_off, k_off))
        return chunk_fwd(q, k, v, scale, causal, q_seg, kv_seg, block_q,
                         block_k, dropout_rate, seed, q_off, k_off)

    def run(after=None):
        return cp.emulate_ring(*shards, layout=layout, causal=True,
                               dropout_rate=rate,
                               seed=CP_SEED if rate else None, after=after)

    run()           # a warm-up: the first launch of a kernel loads it
    reset_kernel_counts(fa, ln, ok)
    last[0] = kernel_counts(fa, ln, ok)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cp._chunk_fwd = recording_fwd
    try:
        os_, dqs, dks, dvs = run(after)
    finally:
        cp._chunk_fwd = chunk_fwd
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    what = f"virtual ring {layout} n={n} rate={rate}"
    for r in range(n):
        chunks = 2 * n + 1 if zz else r + 1
        if zz:
            fwd, bwd = _per_iter(fwd=chunks, drop=rate > 0), _per_iter(
                fused=chunks, f32=True, drop=rate > 0)
        else:
            fwd, bwd = _per_iter(fwd=chunks, drop=rate > 0), _per_iter(
                dq=chunks, dkv=chunks, f32=True, drop=rate > 0)
        for stage, want in (("fwd", fwd), ("bwd", bwd)):
            got = by_rank[(stage, r)]
            for key, c in want.items():
                check(got.get(key, 0) == c, f"{what} rank {r} {stage}: {key} "
                      f"{got.get(key, 0)} launches, want {c}")
    cat = [torch.cat(t, dim=2) for t in (os_, dqs, dks, dvs)]
    if zz:
        cat = [cp.zigzag_unshard(t, n) for t in cat]
    qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))
    drop = (rate, fa._seed3(CP_SEED)) if rate else ()
    o_ref = fa._FlashFn.apply(qr, kr, vr, sc, True, None, None, 1, *drop)
    refs = (o_ref.detach(),) + torch.autograd.grad(o_ref, (qr, kr, vr), do)
    errs = {name: max_err(torch, f"{what} {name}", a, b_)
            for name, a, b_ in zip(("o", "dq", "dk", "dv"), cat, refs)}
    masks = {}
    if rate:
        for q_off, k_off in sorted(offsets):
            masks[f"{q_off},{k_off}"] = check_dropout_mask(
                torch, fa, b=1, h=8, d=64, rate=rate, q_off=q_off,
                k_off=k_off, seed=CP_SEED)
    del cat, refs, o_ref, os_, dqs, dks, dvs, shards
    torch.cuda.empty_cache()
    return {"layout": layout, "rate": rate, "ranks": n, "ms": ms,
            "max_err_vs_flash_attention": errs,
            "launches_by_rank": {f"{s_} rank {r}": c
                                 for (s_, r), c in sorted(by_rank.items())},
            "chunk_offsets": len(offsets),
            "dropout_mask_keep_shares": masks}


def virtual_ring_legs(torch, fa, ln, ok, rng, cp):
    """Slice 20 (b): the 32k shape as VIRTUAL_RANKS shards on the one
    card, contiguous and zigzag, causal, at dropout 0 and 0.1."""
    qkvd = [torch.randn(LONG_SHAPE, generator=rng, device="cuda")
            .to(torch.bfloat16) for _ in range(4)]
    legs = {}
    for layout in ("contiguous", "zigzag"):
        for rate in (0.0, 0.1):
            legs[f"{layout} rate={rate}"] = virtual_ring_leg(
                torch, fa, ln, ok, cp, layout, rate, qkvd)
            log(f"slice 20 virtual ring {layout} rate={rate} "
                + json.dumps(legs[f"{layout} rate={rate}"]))
    del qkvd
    torch.cuda.empty_cache()
    return legs


def plain_chunks(torch, fa):
    """The ring's chunk functions as the plain versions in fp32 (q, k, v,
    do upcast), for running the ring's model on the card without the
    kernels."""

    def fwd(q, k, v, scale, causal, q_seg, kv_seg, block_q, block_k,
            dropout_rate=0.0, seed=None, q_off=0, k_off=0):
        return fa.flash_fwd_reference(
            q.float(), k.float(), v.float(), scale, causal, q_seg, kv_seg,
            dropout_rate, fa._seed3(seed, q_off, k_off))

    def bwd(q, k, v, o, lse, do, scale, causal, q_seg, kv_seg, block_q,
            block_k, dropout_rate=0.0, seed=None, q_off=0, k_off=0):
        delta = torch.sum(do.float() * o.float(), dim=-1)
        args = (q.float(), k.float(), v.float(), do.float(), lse, delta,
                scale, causal, q_seg, kv_seg, dropout_rate,
                fa._seed3(seed, q_off, k_off))
        return (fa.flash_bwd_dq_reference(*args, out_dtype=torch.float32),
                *fa.flash_bwd_dkv_reference(*args,
                                            out_dtype=torch.float32))

    return fwd, bwd


# the long-context example's first-step gradients through the kernels
# against the plain fp32 chunks', relative L2 a parameter (q, k, v enter
# the ring as bf16 on both routes; the kernels round the probabilities
# to bf16 for the P·V and dS products)
EXAMPLE_GRAD_TOL = 1e-2


def example_leg(torch, fa, ln, ok, cp, group, warmup=1, steps=3):
    """Slice 20 (c): examples/torch_long_context_training.py at its own
    defaults (seq 32768, hidden 128, 2 heads of 64, 2 layers, vocab 512,
    FusedAdam lr 3e-3) on the one-rank NCCL group, `warmup` + `steps`
    steps: the loss falls; launches a step (per layer the zigzag ring's
    three half-chunk forwards and the split pair's three dq and dk/dv
    passes at 16384 keys, fp32; one Adam); no host sync in a step; one
    profiled step; the first-step loss within 2e-3 relative of the same
    model with the plain fp32 chunk versions on the card, and the
    first-step gradient of every parameter within EXAMPLE_GRAD_TOL
    (relative L2) of that model's."""
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.optimizers import flat as F

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "examples"))
    import torch_long_context_training as ex

    a = ex.parse([])
    check((a.seq, a.hidden, a.heads, a.layers, a.vocab) == (32768, 128, 2, 2,
                                                            512),
          "the long-context example's defaults drifted")
    dev = torch.device("cuda", 0)
    params = ex.init_params(0, a, dev)
    data = ex.make_data(a, 1, dev)

    def loss_and_grads():
        ps = {k: ({n_: v.detach().requires_grad_(True) for n_, v in p.items()}
                  if isinstance(p, dict) else p.detach().requires_grad_(True))
              for k, p in params.items()}
        loss = ex.forward_loss(ps, *data, a, group)
        pairs = F.tree_leaves_with_paths(ps)
        grads = torch.autograd.grad(loss, [leaf for _, leaf in pairs])
        return float(loss), {"/".join(path): g
                             for (path, _), g in zip(pairs, grads)}

    first, grads = loss_and_grads()
    saved = cp._chunk_fwd, cp._chunk_bwd
    cp._chunk_fwd, cp._chunk_bwd = plain_chunks(torch, fa)
    try:
        plain, plain_grads = loss_and_grads()
    finally:
        cp._chunk_fwd, cp._chunk_bwd = saved
    rel = abs(first - plain) / abs(plain)
    check(rel <= 2e-3, f"long-context example: first loss {first} through "
          f"the kernels, {plain} through the plain fp32 chunks")
    grad_rel = {name: ((g - plain_grads[name]).norm()
                       / plain_grads[name].norm()).item()
                for name, g in grads.items()}
    worst = max(grad_rel, key=grad_rel.get)
    check(grad_rel[worst] <= EXAMPLE_GRAD_TOL,
          f"long-context example: first-step gradient of {worst} "
          f"{grad_rel[worst]:.3e} (relative L2) from the plain fp32 chunks'")
    del grads, plain_grads
    opt = FusedAdam(lr=a.lr)
    state = opt.init(params)
    step = ex.make_step(opt, a, group)
    per_step = dict(_per_iter(fwd=3 * a.layers, dq=3 * a.layers,
                              dkv=3 * a.layers, f32=True), adam=1)
    state, line = train_loop(torch, fa, ln, ok, "long-context example", step,
                             state, data, per_step, warmup, steps)
    check(abs(line["losses"][0] - first) <= 1e-6 * abs(first),
          f"long-context example: the step's first loss "
          f"{line['losses'][0]} is not the forward's {first}")
    state, _ = step_without_sync(torch, step, state, *data)
    state, prof = profile_step(torch, step, state, data, {
        "flash_attention_fwd": lambda k_: "flash_fwd" in k_,
        "flash_attention_bwd_dq": lambda k_: "flash_bwd_dq" in k_,
        "flash_attention_bwd_dkv": lambda k_: "flash_bwd_kernel" in k_,
        "adam": lambda k_: "adam" in k_})
    line.update({"config": {"seq": a.seq, "hidden": a.hidden,
                            "heads": a.heads, "layers": a.layers,
                            "vocab": a.vocab, "lr": a.lr},
                 "tokens_per_s": a.seq / (line["step_ms"] / 1e3),
                 "first_loss_plain_fp32_chunks": plain,
                 "first_loss_rel_diff_vs_plain": rel,
                 "first_grads_rel_l2_vs_plain": grad_rel,
                 "first_grads_rel_l2_max": grad_rel[worst],
                 "no_host_sync": True,
                 "profile": prof})
    del state, params, data
    torch.cuda.empty_cache()
    return line


def slice20_phase(torch, fa, ln, ok, rng, phase9_ms):
    """Phase 17 (module docstring): (a) and (c) on the card as a one-rank
    NCCL group (the ring and Ulysses over the world group), (b) with no
    process group, four virtual ranks through `emulate_ring`."""
    import torch.distributed as dist
    from apex_tpu_torch.parallel import context_parallel as cp

    t0 = time.perf_counter()
    out = {}
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        group = dist.group.WORLD
        check(dist.get_backend(group) == "nccl"
              and dist.get_world_size(group) == 1,
              "slice 20: the world is not a one-rank NCCL group")
        out["one_rank"] = one_rank_ring_legs(torch, fa, ln, ok, rng, cp,
                                             group, phase9_ms)
        log("slice 20 one-rank legs " + json.dumps(out["one_rank"]))
        out["example"] = example_leg(torch, fa, ln, ok, cp, group)
        log("slice 20 long-context example " + json.dumps(out["example"]))
    finally:
        dist.destroy_process_group()
    out["virtual"] = virtual_ring_legs(torch, fa, ln, ok, rng, cp)
    log(f"phase 17 {time.perf_counter() - t0:.1f}s")
    return out


SLICE20_ROWS = ("flash_attention_fwd", "flash_attention_bwd",
                "flash_attention_bwd_dq", "flash_attention_bwd_dkv")


def add_slice20_columns(rows, slice20, f32_times):
    """The kernel table's slice-20 columns: on each flash row a phase-17
    leg launched, its launches by leg, its fp32 launches (the backward
    rows) and, for the backward kernels, their times with fp32 outputs
    at the ring's chunk shapes beside the bf16 launches' and the
    bounds."""
    legs = {f"one-rank {k}": v["launches"]
            for k, v in slice20["one_rank"].items()}
    legs["example"] = slice20["example"]["launches"]
    for name, leg in slice20["virtual"].items():
        total = {}
        for counts in leg["launches_by_rank"].values():
            for key, c in counts.items():
                total[key] = total.get(key, 0) + c
        legs[f"virtual {name}"] = total
    kern = {"flash_attention_bwd": "fused", "flash_attention_bwd_dq": "dq",
            "flash_attention_bwd_dkv": "dkv"}
    for row in rows:
        name = row["name"]
        if name not in SLICE20_ROWS:
            continue
        by_leg = {leg: c[name] for leg, c in legs.items() if c.get(name)}
        if by_leg:
            row["launches_slice20"] = by_leg
        if name in kern:
            row["f32_launches_slice20"] = {
                leg: c[f"{name}_f32"] for leg, c in legs.items()
                if c.get(f"{name}_f32")}
            row["f32_outputs"] = {
                k_: t for k_, t in f32_times.items()
                if k_.startswith(kern[name] + " ")}


# ------------------------ slice 21: Mixture-of-Experts ------------------------

# the MoE-GPT bench step's launches (12 layers: one flash forward and fused
# backward a layer, two LayerNorms a layer and the final one, one Adam a
# bucket; no other flash route, no segmented Adam)
MOE_PER_STEP = {"flash_attention_fwd": 12, "flash_attention_bwd": 12,
                "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
                "flash_attention_fwd_packed": 0,
                "flash_attention_bwd_packed": 0, "layer_norm_fwd": 25,
                "layer_norm_bwd": 25, "adam": 2, "adam_seg": 0}
MOE_KERNEL_NAMES = {
    "flash_attention_fwd": lambda k: "flash_fwd_kernel" in k,
    "flash_attention_bwd": lambda k: "flash_bwd_kernel" in k,
    "layer_norm_fwd": lambda k: "ln_fwd_kernel" in k,
    "layer_norm_bwd": lambda k: "ln_bwd_" in k,
    "adam": lambda k: k == "_adam_kernel"}
# the dense anchor's limit: the MoE step against the dense one, in units
# of the dense step's own run-to-run difference
ANCHOR_RUN_TO_RUN = 3.0
# overlap_chunks 2 against 1 at the bench's shapes, of each tensor's
# largest magnitude
MOE_CHUNKS_TOL = 1e-2


def moe_bench_leg(torch, fa, ln, ok, warmup=3, steps=20):
    """Slice 21 (a): bench.py's `_moe_gpt_bench` (bench.py:856-900)
    through the port's `build_moe_train_step()` on the one-rank NCCL
    group (ep 1, dp 1): MoE-GPT at the JAX bench's on-chip configuration
    (vocab 50304, seq 1024, hidden 1024, 12 layers, 16 heads, 8 experts,
    top 2, capacity factor 1.25, bf16, bf16 logits, flash) at batch 8,
    ZeRO-2 DistributedFusedAdam(lr=1e-4, n_buckets=2, master bf16) over
    the (dp, ep) group; `warmup` + `steps` steps on one seeded batch: the
    loss finite and falling, the launches a step (MOE_PER_STEP), the aux
    scalars finite, no host sync, one profiled step.  Returns the line and
    the batch."""
    from apex_tpu_torch.models.moe_gpt import build_moe_train_step
    from apex_tpu_torch.moe.router import expert_capacity

    _, step, (state, _, (shape, _)), info = build_moe_train_step()
    c, opt = info["config"], info["optimizer"]
    check((info["ep"], info["dp"], info["batch"], c.vocab_size, c.seq_len,
           c.hidden, c.num_layers, c.num_heads, c.n_experts, c.top_k,
           c.capacity_factor, c.dtype, c.use_flash_attention)
          == (1, 1, 8, 50304, 1024, 1024, 12, 16, 8, 2, 1.25, torch.bfloat16,
              True), f"the MoE bench configuration drifted: {c}")
    layout = opt.shard_layout()
    check(layout["n_buckets"] == 2 and layout["num_shards"] == 1
          and "ep_shards" not in layout, f"MoE ZeRO layout {layout}")
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, c.vocab_size, tuple(shape), generator=gen,
                           device="cuda", dtype=torch.int32)
    labels = torch.roll(tokens, -1, dims=1)
    last = {}
    fn = zero_step_fn(step, last)
    state, res = train_loop(torch, fa, ln, ok, "moe_gpt", fn, state,
                            ((tokens, labels),), MOE_PER_STEP, warmup, steps)
    aux = {k: float(v) for k, v in last["aux"].items()}
    check(all(math.isfinite(v) for v in aux.values()),
          f"moe_gpt: an aux scalar is not finite {aux}")
    state, syncs = step_without_sync(torch, fn, state, (tokens, labels))
    state, prof = profile_step(torch, fn, state, ((tokens, labels),),
                               MOE_KERNEL_NAMES)
    t = info["batch"] * info["seq"]
    line = dict(
        res, config="MoE-GPT vocab 50304, seq 1024, hidden 1024, 12 layers, "
        "16 heads, 8 experts, top 2, capacity factor 1.25, bf16 (bf16 "
        "logits), flash; batch 8; DistributedFusedAdam(lr=1e-4, n_buckets=2, "
        "master bf16) through ddp.make_train_step on a one-rank NCCL group "
        "(ep 1)", params=sum(opt.spec.sizes),
        capacity=expert_capacity(t, c.n_experts, c.top_k, c.capacity_factor),
        tokens_per_s=t * steps / res["window_s"], aux=aux,
        host_syncs_per_step=len(syncs), profile=prof)
    del state, step, opt, info
    torch.cuda.empty_cache()
    return line, tokens, labels


def moe_vs_plain(torch, fa, ln, ok, tokens, labels):
    """Slice 21 (b): the bench configuration at 2 layers, one step at two
    of the batch's sequences through the kernels and one through their
    plain versions (the flash pair, the LayerNorm, Adam) with
    DistributedFusedAdam(num_shards=1, lr=1e-4, one bucket, master bf16):
    `kernels_vs_plain_step`'s limits, with the routing pinned.  Top-k
    routing is discontinuous: a token whose second and third gate
    probabilities lie closer than the kernels' bf16 roundings move them
    changes experts, and with it a whole row of an expert's gradient (at
    2048 tokens a few such flips moved the median gradient by 4-8 %,
    the router's by 12-15 %, where the dense step's move by < 1 %).  So
    the plain run (which runs first) records each layer's expert choices
    and the kernels' run takes them (its gates the probabilities it
    computes at those choices), and the choices the kernels' run would
    have made itself are counted apart (`routing_flips`)."""
    import dataclasses

    from apex_tpu_torch.models import gpt as gpt_mod
    from apex_tpu_torch.models import moe_gpt as moe_mod
    from apex_tpu_torch.moe import router as R
    from apex_tpu_torch.optimizers import DistributedFusedAdam

    cfg = dataclasses.replace(moe_mod.bench_config(), num_layers=2)
    swaps = (attention_swaps(gpt_mod, fa, cfg)
             + [(moe_mod, "fused_layer_norm", ln.layer_norm_reference),
                (ok, "adam_flat_triton", plain_adam(ok))])
    topk_gates, choices = R.topk_gates, []
    flips = torch.zeros((), dtype=torch.int64, device="cuda")

    def pinned(x, wg, top_k, block_rows=None):
        out = topk_gates(x, wg, top_k, block_rows)
        if len(choices) < cfg.num_layers:          # the plain run's
            choices.append(out.idx)
            return out
        idx = choices[len(choices) % cfg.num_layers]
        choices.append(idx)
        flips.add_((out.idx != idx).sum())
        return out._replace(idx=idx,
                            gate=out.probs.gather(1, idx.long()))

    R.topk_gates = pinned
    try:
        line = kernels_vs_plain_step(
            torch, fa, ln, ok, "moe_gpt (routing pinned)",
            moe_mod.MoEGPT(cfg),
            lambda params: DistributedFusedAdam(1, lr=1e-4,
                                                master_dtype=torch.bfloat16),
            None, swaps, tokens[:2], labels[:2])
    finally:
        R.topk_gates = topk_gates
    check(len(choices) == 2 * cfg.num_layers,
          f"moe_gpt kernels vs plain: {len(choices)} routings, want "
          f"{2 * cfg.num_layers}")
    line["routing_flips"] = int(flips)
    line["routed_assignments"] = int(2 * cfg.seq_len * cfg.top_k
                                     * cfg.num_layers)
    return line


def moe_dense_anchor(torch, tokens, labels, steps=3):
    """Slice 21 (c): the JAX package's dense anchor (tests/test_moe.py:
    162-168) on the card: MoEGPT at the bench's width with n_experts 1,
    top_k 1, capacity factor inf and aux / z coefficients 0, its experts
    the fc1 / fc2 of a dense GPT of the same width and every other weight
    that GPT's (the same seed), against that GPT, each through
    ddp.make_train_step with DistributedFusedAdam(1, lr=1e-4, n_buckets=2,
    master bf16), `steps` steps on the bench batch; the dense model twice.
    The MoE step's losses (the largest difference over the steps) and its
    updated params (L2 over every leaf, the router's excluded, which gets
    no gradient and must not move) within ANCHOR_RUN_TO_RUN times the
    dense step's own run-to-run difference."""
    import dataclasses

    from apex_tpu_torch.models import gpt as gpt_mod
    from apex_tpu_torch.models import moe_gpt as moe_mod
    from apex_tpu_torch.optimizers import DistributedFusedAdam
    from apex_tpu_torch.optimizers import flat as F
    from apex_tpu_torch.parallel import ddp

    mcfg = dataclasses.replace(moe_mod.bench_config(), n_experts=1, top_k=1,
                               capacity_factor=float("inf"), aux_coef=0.0,
                               z_coef=0.0)
    dcfg = gpt_mod.GPTConfig(**{f.name: getattr(mcfg, f.name)
                                for f in dataclasses.fields(gpt_mod.GPTConfig)})
    dense, moe = gpt_mod.GPT(dcfg), moe_mod.MoEGPT(mcfg)
    dparams, mparams = dense.init(seed=0), moe.init(seed=0)
    for i in range(mcfg.num_layers):
        bp, dbp = mparams[f"block{i}"], dparams[f"block{i}"]
        bp["moe"].update(w1=dbp["fc1"]["weight"][None],
                         b1=dbp["fc1"]["bias"][None],
                         w2=dbp["fc2"]["weight"][None],
                         b2=dbp["fc2"]["bias"][None])
    ren = {("fc1", "weight"): ("moe", "w1"), ("fc1", "bias"): ("moe", "b1"),
           ("fc2", "weight"): ("moe", "w2"), ("fc2", "bias"): ("moe", "b2")}

    def run(model, params, has_aux):
        opt = DistributedFusedAdam(1, lr=1e-4, n_buckets=2,
                                   master_dtype=torch.bfloat16)
        state = opt.init(params)

        def loss_fn(p, b):
            return (model.loss_with_stats(p, *b) if has_aux
                    else model.loss(p, *b))

        step = ddp.make_train_step(loss_fn, opt, has_aux=has_aux)
        losses = []
        for _ in range(steps):
            out = step(state, None, (tokens, labels))
            state = out[0]
            losses.append(float(out[2]))
        return losses, opt.full_params(state)

    d1, d2, m = (run(dense, dparams, False), run(dense, dparams, False),
                 run(moe, mparams, True))
    pairs = []
    for path, leaf in F.tree_leaves_with_paths(d1[1]):
        q = path[:-2] + ren.get(path[-2:], path[-2:])
        other = m[1]
        for key in q:
            other = other[key]
        pairs.append((leaf, other.reshape(leaf.shape)))
    d2_leaves = F.tree_leaves(d2[1])
    moved = [m[1][f"block{i}"]["moe"]["wg"] for i in range(mcfg.num_layers)]
    check(all(torch.equal(w, mparams[f"block{i}"]["moe"]["wg"])
              for i, w in enumerate(moved)),
          "dense anchor: the router's weight moved (it gets no gradient)")

    def l2(xs, ys):
        return sum((x.float() - y.float()).norm() ** 2
                   for x, y in zip(xs, ys)).sqrt().item()

    ref = [a for a, _ in pairs]
    line = {
        "steps": steps, "losses_dense": d1[0], "losses_dense_again": d2[0],
        "losses_moe": m[0],
        "loss_diff_moe": max(abs(a - b) for a, b in zip(m[0], d1[0])),
        "loss_diff_dense_run_to_run": max(abs(a - b)
                                          for a, b in zip(d2[0], d1[0])),
        "param_l2_moe": l2([b for _, b in pairs], ref),
        "param_l2_dense_run_to_run": l2(d2_leaves, ref),
        "losses_bit_for_bit": m[0] == d1[0],
        "params_bit_for_bit": all(torch.equal(a, b) for a, b in pairs)}
    log("slice 21 dense anchor " + json.dumps(line))
    check(line["loss_diff_moe"]
          <= ANCHOR_RUN_TO_RUN * line["loss_diff_dense_run_to_run"]
          and line["param_l2_moe"]
          <= ANCHOR_RUN_TO_RUN * line["param_l2_dense_run_to_run"],
          f"dense anchor: the MoE step (n_experts 1) is further from the "
          f"dense step than {ANCHOR_RUN_TO_RUN}x its own run-to-run: {line}")
    del d1, d2, m, pairs, dparams, mparams, d2_leaves, ref
    torch.cuda.empty_cache()
    return line


def moe_routed_forms(torch, rng):
    """Slice 21 (d): at the bench step's shapes (8192 tokens of hidden
    1024, 8 experts, top 2, bf16, capacity 2560): the blocked router at
    block_rows 1024 bit for bit the dense router (probs, gate, idx,
    logits), both timed; MoEMLP forward and backward (a seeded
    cotangent) at overlap_chunks 2 against 1: y, dx and each parameter's
    gradient within MOE_CHUNKS_TOL of its largest magnitude, whether
    each is bit for bit reported."""
    from apex_tpu_torch.moe import router as R
    from apex_tpu_torch.moe.layer import MoEMLP

    bf16 = torch.bfloat16
    x = torch.randn((8192, 1024), generator=rng, device="cuda").to(bf16)
    cot = torch.randn((8192, 1024), generator=rng, device="cuda").to(bf16)
    params = MoEMLP(1024, 4096, 8, top_k=2).init(seed=3, dtype=bf16)
    dense = R.topk_gates_dense(x, params["wg"], 2)
    blocked = R.topk_gates_blocked(x, params["wg"], 2, 1024)
    for f in dense._fields:
        check(torch.equal(getattr(dense, f), getattr(blocked, f)),
              f"moe router: blocked (1024 rows) {f} is not the dense one's")
    out = {"router_blocked_1024_bit_for_bit": True,
           "router_dense_ms": time_ms(torch, lambda: R.topk_gates_dense(
               x, params["wg"], 2), n=20),
           "router_blocked_ms": time_ms(torch, lambda: R.topk_gates_blocked(
               x, params["wg"], 2, 1024), n=20)}
    names = sorted(params)

    def fwd_bwd(chunks):
        layer = MoEMLP(1024, 4096, 8, top_k=2, capacity_factor=1.25,
                       overlap_chunks=chunks)
        ps = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        xx = x.detach().requires_grad_(True)
        y, _ = layer.apply(ps, xx)
        grads = torch.autograd.grad(y, [ps[k] for k in names] + [xx], cot)
        return [y.detach()] + list(grads)

    one, two = fwd_bwd(1), fwd_bwd(2)
    out["chunks2_vs_1"] = {
        name: {"max_err": max_err(torch, f"moe chunks 2 vs 1 {name}", b, a,
                                  tol=MOE_CHUNKS_TOL),
               "bit_for_bit": bool(torch.equal(a, b))}
        for name, a, b in zip(["y"] + names + ["x"], one, two)}
    del x, cot, params, dense, blocked, one, two
    torch.cuda.empty_cache()
    return out


def slice21_phase(torch, fa, ln, ok, rng):
    """Phase 18 (module docstring): (a), (b) and (c) on the card as a
    one-rank NCCL group (`build_moe_train_step` meshes over it: ep 1),
    (d) the routed forms at the bench's shapes."""
    import torch.distributed as dist
    from apex_tpu_torch.parallel import mesh

    t0 = time.perf_counter()
    out = {}
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        out["bench"], tokens, labels = moe_bench_leg(torch, fa, ln, ok)
        group = mesh.data_parallel_group()
        check(group is not None and dist.get_backend(group) == "nccl"
              and mesh.get_expert_model_parallel_world_size() == 1
              and mesh.get_data_parallel_axis_names() == ("dp",),
              "slice 21: the data group is not a one-rank NCCL group at ep 1")
        log("slice 21 MoE bench " + json.dumps(out["bench"]))
        out["vs_plain"] = moe_vs_plain(torch, fa, ln, ok, tokens, labels)
        out["dense_anchor"] = moe_dense_anchor(torch, tokens, labels)
    finally:
        mesh.destroy_model_parallel()
        dist.destroy_process_group()
    out["routed"] = moe_routed_forms(torch, rng)
    log("slice 21 routed forms " + json.dumps(out["routed"]))
    log(f"phase 18 {time.perf_counter() - t0:.1f}s")
    return out


SLICE21_ROWS = ("flash_attention_fwd", "flash_attention_bwd",
                "layer_norm_fwd", "layer_norm_bwd", "adam")


def add_slice21_columns(rows, slice21):
    """The kernel table's slice-21 column: on each row the MoE-GPT bench
    step launched, its launches in that leg (3 + 20 steps) and a step."""
    leg = slice21["bench"]
    for row in rows:
        name = row["name"]
        if name in SLICE21_ROWS:
            row["launches_slice21"] = {
                "moe bench": leg["launches"][name],
                "per_step": leg["launches_per_step"][name]}


# ------------- slice 22: BERT at tp > 1 and the checkpoint package -------------

# bench.py's `_ckpt_cycle` at its on-chip size: GPT at h1024, 8 layers
CKPT_GPT = dict(vocab_size=50304, seq_len=1024, hidden=1024, num_layers=8,
                num_heads=16)
CKPT_BATCH = 8
# per step: flash 8 + 8, LayerNorm 2 a layer + the final one, Adam 1 a
# bucket (two buckets)
CKPT_PER_STEP = {"flash_attention_fwd": 8, "flash_attention_bwd": 8,
                 "layer_norm_fwd": 17, "layer_norm_bwd": 17, "adam": 2}
# the resumed run's distance from the baseline, in units of a second
# unpreempted run's (phase 18's gate 3)
RESUME_RUN_TO_RUN = ANCHOR_RUN_TO_RUN
# phase 6's kernels-vs-plain loss limit (`kernels_vs_plain_step`)
BERT_TP_LOSS_TOL = 1e-3


def bert_tp_leg(torch, fa, ln, ok, bert):
    """Slice 22 (a): phase 6's BERT-Large step (`bert_phase`: 1 + 4
    steps, the unmasked two and the 2-layer kernels-vs-plain step)
    through the mesh's tp and dp groups, one-rank NCCL groups here: the
    launches a step phase 6's, the first loss within phase 6's
    kernels-vs-plain loss limit of phase 6's first loss."""
    res, vs_plain = bert_phase(torch, fa, ln, ok)
    check(res["launches_per_step"] == bert["launches_per_step"],
          f"BERT tp: launches a step {res['launches_per_step']}, phase 6 "
          f"{bert['launches_per_step']}")
    first, want = res["losses"][0], bert["losses"][0]
    check(abs(first - want) <= BERT_TP_LOSS_TOL * abs(want),
          f"BERT tp: first loss {first}, phase 6's {want}")
    return {"config": res["config"] + "; through make_tp_dp_train_step "
            "over the mesh's tp and dp groups (one-rank NCCL)",
            "steps": res["steps"], "losses": res["losses"],
            "phase6_first_loss": want,
            "first_loss_rel_diff": abs(first - want) / abs(want),
            "seq_per_s": res["seq_per_s"], "step_ms": res["step_ms"],
            "device_ms": res["profile"]["device_ms"],
            "peak_mem_gib": res["peak_mem_gib"],
            "host_syncs_per_step": res["host_syncs_per_step"],
            "launches": res["launches"],
            "launches_per_step": res["launches_per_step"],
            "vs_plain": vs_plain}


def ckpt_gpt(torch):
    """(b)'s model and step: GPT (CKPT_GPT) in bf16 with bf16 logits and
    flash attention, DistributedFusedAdam(1, lr=1e-4, n_buckets=2,
    master bf16) through `ddp.make_train_step` on the one-rank dp group,
    one seeded batch.  Returns (fresh, batch): fresh() builds the
    optimizer, its state from the seed-0 weights and the step."""
    from apex_tpu_torch.models import gpt as gpt_mod
    from apex_tpu_torch.optimizers import DistributedFusedAdam
    from apex_tpu_torch.parallel import ddp

    bf16 = torch.bfloat16
    model = gpt_mod.GPT(gpt_mod.GPTConfig(
        **CKPT_GPT, dropout=0.0, dtype=bf16, logits_dtype=bf16,
        use_flash_attention=True))

    def fresh():
        opt = DistributedFusedAdam(1, lr=1e-4, n_buckets=2,
                                   master_dtype=bf16)
        state = opt.init(model.init(seed=0))
        step = zero_step_fn(ddp.make_train_step(
            lambda p, b: model.loss(p, *b), opt))
        return opt, state, step

    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, CKPT_GPT["vocab_size"],
                           (CKPT_BATCH, CKPT_GPT["seq_len"]), generator=gen,
                           device="cuda", dtype=torch.int32)
    return fresh, (tokens, torch.roll(tokens, -1, dims=1))


def timed_step(torch, step, state, batch):
    """One step: (state, wall ms on the host's clock, device ms between
    CUDA events around it)."""
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e0.record()
    state, _ = step(state, batch)
    e1.record()
    torch.cuda.synchronize()
    return state, 1e3 * (time.perf_counter() - t0), e0.elapsed_time(e1)


def ckpt_cycle_leg(torch, gpt, tmp, trials=3):
    """Slice 22 (b): bench.py's `_ckpt_cycle` (bench.py:669-750): one
    step, then CheckpointManager(every_n_steps=1) save, wait, restore:
    every state field back bit for bit.  Then the writer's cost to the
    step: `trials` steps with no write, and `trials` steps each right
    after a save() (its write in flight on the writer thread)."""
    from apex_tpu_torch.checkpoint import CheckpointManager

    fresh, batch = gpt
    opt, state, step = fresh()
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    mgr = CheckpointManager(tmp, opt, every_n_steps=1)
    check(not mgr.multihost, "ckpt cycle: a one-rank group saves alone")
    mgr.save(1, state)
    mgr.wait()
    st = mgr.stats()
    t0 = time.perf_counter()
    restored, _, manifest = mgr.restore()
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check(manifest["step"] == 1 and all(
        torch.equal(getattr(restored, f), getattr(state, f))
        for f in state._fields),
        "ckpt cycle: the restored state is not the saved one bit for bit")
    del restored
    quiet, busy, in_flight = [], [], []
    for _ in range(trials):
        state, wall, dev = timed_step(torch, step, state, batch)
        quiet.append((wall, dev))
    for i in range(trials):
        mgr.save(2 + i, state)
        state, wall, dev = timed_step(torch, step, state, batch)
        in_flight.append(mgr._thread is not None and mgr._thread.is_alive())
        busy.append((wall, dev))
        mgr.wait()
    check(any(in_flight), "ckpt cycle: every write finished within its "
          "step; no step ran with a write in flight")
    busy = [b for b, f in zip(busy, in_flight) if f]

    def med(xs):
        return sorted(xs)[len(xs) // 2]

    line = {"config": "GPT vocab 50304, seq 1024, hidden 1024, 8 layers, "
            "16 heads, bf16 (bf16 logits), flash; batch 8; "
            "DistributedFusedAdam(1, lr=1e-4, n_buckets=2, master bf16) "
            "through ddp.make_train_step on a one-rank NCCL group; "
            "CheckpointManager(every_n_steps=1) under a temporary directory",
            "params": sum(opt.spec.sizes),
            "ckpt_blocking_s": st["ckpt_blocking_s"],
            "ckpt_save_s": st["ckpt_save_s"], "ckpt_bytes": st["ckpt_bytes"],
            "restore_s": restore_s, "roundtrip_bit_for_bit": True,
            "step_wall_ms_no_write": med([w for w, _ in quiet]),
            "step_device_ms_no_write": med([d for _, d in quiet]),
            "step_wall_ms_write_in_flight": med([w for w, _ in busy]),
            "step_device_ms_write_in_flight": med([d for _, d in busy]),
            "steps_with_write_in_flight": len(busy),
            "each_step_ms_no_write": quiet, "each_step_ms_in_flight": busy,
            "blocking_s_last_save": mgr.stats()["ckpt_blocking_s"],
            "save_s_last_save": mgr.stats()["ckpt_save_s"]}
    del state, opt, step, mgr
    torch.cuda.empty_cache()
    return line


def resume_leg(torch, fa, ln, ok, gpt, tmp, steps=8, at=4, kill_at=6):
    """Slice 22 (c): the save → kill → resume gate (the counterpart of
    scripts/resume_probe.py stages 1-4) on (b)'s model.  The baseline:
    `steps` steps, a commit at step `at`, and a save at `kill_at` killed
    by the `ckpt.mid_shards` fail point (that directory does not load,
    `latest_committed_step` stays `at`).  A second unpreempted run gives
    the card's run-to-run spread.  A fresh optimizer and manager restore
    step `at` (bit for bit the committed state) and replay the rest: the
    first replayed loss bit for bit the baseline's, the later losses and
    the final master flat within RESUME_RUN_TO_RUN x the spread.  Then
    the elastic gate: the committed state written by `save_sharded` as
    a dp = 4 layout from four virtual shards restores at dp = 1 to the
    committed shards bit for bit."""
    from apex_tpu_torch.checkpoint import (CheckpointManager, chaos,
                                           latest_committed_step)
    from apex_tpu_torch.checkpoint import sharded as S

    fresh, batch = gpt

    def run(mgr_dir=None):
        opt, state, step = fresh()
        mgr = (CheckpointManager(mgr_dir, opt, every_n_steps=at, keep=4)
               if mgr_dir else None)
        losses, committed = [], None
        reset_kernel_counts(fa, ln, ok)
        for i in range(1, steps + 1):
            state, loss = step(state, batch)
            losses.append(loss)
            if mgr is not None and i == at:
                check(mgr.maybe_save(i, state), "resume: no save at step "
                      f"{at}")
                mgr.wait()
                committed = {f: getattr(state, f).clone()
                             for f in state._fields}
            if mgr is not None and i == kill_at:
                with chaos.preempt_at("ckpt.mid_shards"):
                    mgr.save(i, state)
                    try:
                        mgr.wait()
                        killed = False
                    except chaos.SimulatedPreemption:
                        killed = True
                check(killed, f"resume: the save at step {kill_at} was not "
                      "killed by ckpt.mid_shards")
                check(latest_committed_step(mgr_dir) == at,
                      f"resume: latest committed step "
                      f"{latest_committed_step(mgr_dir)} after the kill, "
                      f"want {at}")
                try:
                    S.read_manifest(S.step_dir(mgr_dir, kill_at))
                    loads = True
                except S.CheckpointError:
                    loads = False
                check(not loads, f"resume: the killed step {kill_at} loads")
        torch.cuda.synchronize()
        counts = kernel_counts(fa, ln, ok)
        for name, n in CKPT_PER_STEP.items():
            check(counts[name] == n * steps, f"resume {name}: {counts[name]} "
                  f"launches in {steps} steps, want {n} a step")
        out = (losses, state.params_shard.clone(), committed, counts)
        del opt, state, step, mgr
        return out

    base, final_a, committed, counts = run(tmp)
    second, final_b = run()[:2]
    opt, _, step = fresh()
    restored, _, manifest = CheckpointManager(tmp, opt).restore()
    check(manifest["step"] == at and all(
        torch.equal(getattr(restored, f), committed[f])
        for f in restored._fields),
        "resume: the restored state is not the committed one bit for bit")
    replay, state = [], restored
    for _ in range(at + 1, steps + 1):
        state, loss = step(state, batch)
        replay.append(loss)
    torch.cuda.synchronize()
    check(torch.equal(replay[0], base[at]),
          f"resume: the first replayed loss {float(replay[0])!r} is not the "
          f"baseline's step-{at + 1} loss {float(base[at])!r} bit for bit")

    def diff(xs, ys):
        return max(abs(float(x) - float(y)) for x, y in zip(xs, ys))

    def l2(x, y):
        return (x.float() - y.float()).norm().item()

    line = {"steps": steps, "committed_at": at, "killed_at": kill_at,
            "losses_baseline": [float(x) for x in base],
            "losses_second_run": [float(x) for x in second],
            "losses_replayed": [float(x) for x in replay],
            "first_replayed_loss_bit_for_bit": True,
            "restored_state_bit_for_bit": True,
            "loss_diff_replayed": diff(replay[1:], base[at + 1:]),
            "loss_diff_run_to_run": diff(second[at:], base[at:]),
            "master_l2_replayed": l2(state.params_shard, final_a),
            "master_l2_run_to_run": l2(final_b, final_a),
            "master_bit_for_bit_replayed": bool(torch.equal(
                state.params_shard, final_a)),
            "launches_per_step": CKPT_PER_STEP}
    log("slice 22 resume " + json.dumps(line))
    check(line["loss_diff_replayed"]
          <= RESUME_RUN_TO_RUN * line["loss_diff_run_to_run"]
          and line["master_l2_replayed"]
          <= RESUME_RUN_TO_RUN * line["master_l2_run_to_run"],
          f"resume: the replayed steps are further from the baseline than "
          f"{RESUME_RUN_TO_RUN}x a second run's: {line}")
    del state, restored, replay, final_a, final_b

    # the elastic gate: the committed state as a dp = 4 layout
    lay1 = opt.shard_layout()
    tile = 4 * ok.FLAT_TILE
    lay4 = dict(lay1, num_shards=4, bucket_padded=[
        -(-t // tile) * tile for t in lay1["bucket_totals"]])
    fields = {"step": ("replicated", committed["step"].cpu())}
    for f in ("params_shard", "exp_avg", "exp_avg_sq"):
        canon = S.canonical_flat([committed[f].cpu()], lay1)
        fields[f] = ("sharded", list(torch.chunk(S.relayout_flat(canon,
                                                                 lay4), 4)))
    dp4 = os.path.join(tmp, "dp4")
    S.save_sharded(dp4, at, fields, flat_layout=lay4)
    back, _, _ = S.restore_sharded(dp4, opt)
    check(all(torch.equal(getattr(back, f), committed[f])
              for f in back._fields),
          "resume: the dp = 4 layout does not restore at dp = 1 bit for bit")
    line["elastic_dp4_to_dp1_bit_for_bit"] = True
    line["dp4_layout_bucket_padded"] = lay4["bucket_padded"]
    line["launches"] = counts
    del back, committed, opt, step
    torch.cuda.empty_cache()
    return line


def fleet_leg(tmp, n=1 << 20, dp=4):
    """Slice 22 (d): bench.py's `_fleet_cycle` (bench.py:765-843) at its
    on-chip size through the port's modules: two emulated hosts commit a
    dp = 4 layout through the sub-manifest file barrier, a half-fleet
    commit of the next step is refused, and the ElasticOrchestrator
    drives one lost-rank recovery whose re-shard to dp = 2 gives back
    the committed canonical flat bit for bit."""
    import numpy as np
    import torch

    from apex_tpu_torch.checkpoint import ElasticOrchestrator
    from apex_tpu_torch.checkpoint import multihost as MH
    from apex_tpu_torch.checkpoint import sharded as S
    from apex_tpu_torch.checkpoint.chaos import RankLostError

    layout = {"align": 64, "total": n, "n_tensors": 1, "num_shards": dp,
              "n_buckets": 1, "bucket_totals": [n], "bucket_padded": [n],
              "master_dtype": "float32"}
    flat = torch.from_numpy(np.random.RandomState(11).randn(n).astype(
        np.float32))
    shards = dict(enumerate(torch.chunk(flat, dp)))
    MH.save_sharded_multihost(
        tmp, 1, {"params_shard": ("sharded", {2: shards[2], 3: shards[3]})},
        process_id=1, num_processes=2, flat_layout=layout)
    _, barrier_s = MH.save_sharded_multihost(
        tmp, 1, {"params_shard": ("sharded", {0: shards[0], 1: shards[1]})},
        process_id=0, num_processes=2, flat_layout=layout, timeout_s=30.0)
    try:
        MH.save_sharded_multihost(
            tmp, 2, {"params_shard": ("sharded",
                                      {0: shards[0], 1: shards[1]})},
            process_id=0, num_processes=2, flat_layout=layout,
            timeout_s=0.2, poll_s=0.02)
        refused = False
    except MH.MultihostCommitError:
        refused = True
    refused = refused and S.latest_committed_step(tmp) == 1
    dst = dict(layout, num_shards=2)

    def build(new_dp, resume_step, attempt):
        def session():
            if new_dp == dp:
                raise RankLostError("rank 3 lost (fleet cycle)", rank=3)
            p = S.step_dir(tmp, resume_step)
            m = S.read_manifest(p)
            host = S.load_field_host(p, m, "params_shard", check_crc=True)
            re2 = S.reshard(host, m["flat_layout"], dst)
            return S.canonical_flat(list(torch.chunk(re2, 2)), dst)
        return session

    orch = ElasticOrchestrator(tmp, build, initial_dp=dp,
                               choose_dp=lambda d, e: 2)
    canon = orch.run()
    line = {"dp": dp, "n": n, "n_hosts": 2, "barrier_s": barrier_s,
            "refused_ok": bool(refused),
            "resumes": orch.stats()["fleet_resumes"],
            "resume_ok": bool(torch.equal(canon, flat))}
    check(line["resume_ok"] and line["refused_ok"] and line["resumes"] == 1,
          f"fleet cycle: {line}")
    return line


def slice22_phase(torch, fa, ln, ok, bert):
    """Phase 19 (module docstring): (a), (b) and (c) on the card as a
    one-rank NCCL group (the tp and dp groups of
    `initialize_model_parallel(tensor_model_parallel_size=1)`), (d) on
    the host; the checkpoints under a temporary directory removed after."""
    import torch.distributed as dist
    from apex_tpu_torch.parallel import mesh

    t0 = time.perf_counter()
    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        mesh.initialize_model_parallel(tensor_model_parallel_size=1)
        groups = {"tp": mesh.get_tensor_model_parallel_group(),
                  "dp": mesh.get_data_parallel_group()}
        check(all(g is not None and dist.get_backend(g) == "nccl"
                  and dist.get_world_size(g) == 1 for g in groups.values()),
              "slice 22: the tp and dp groups are not one-rank NCCL groups")
        out["bert_tp"] = bert_tp_leg(torch, fa, ln, ok, bert)
        log("slice 22 BERT tp " + json.dumps(out["bert_tp"]))
        torch.cuda.empty_cache()
        gpt = ckpt_gpt(torch)
        out["ckpt"] = ckpt_cycle_leg(torch, gpt, os.path.join(tmp, "cycle"))
        log("slice 22 ckpt cycle " + json.dumps(out["ckpt"]))
        out["resume"] = resume_leg(torch, fa, ln, ok, gpt,
                                   os.path.join(tmp, "resume"))
    finally:
        mesh.destroy_model_parallel()
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    try:
        out["fleet"] = fleet_leg(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("slice 22 fleet cycle " + json.dumps(out["fleet"]))
    log(f"phase 19 {time.perf_counter() - t0:.1f}s")
    return out


def add_slice22_columns(rows, slice22):
    """The kernel table's slice-22 column: on each row phase 19's legs
    launched, its launches in the BERT tp leg (1 + 4 steps) and in the
    resume gate's baseline run (8 steps), and a step of each."""
    bert, resume = slice22["bert_tp"], slice22["resume"]
    for row in rows:
        name = row["name"]
        col = {}
        if bert["launches_per_step"].get(name):
            col["bert tp"] = bert["launches"][name]
            col["bert tp per_step"] = bert["launches_per_step"][name]
        if name in CKPT_PER_STEP:
            col["ckpt gpt resume baseline"] = resume["launches"][name]
            col["ckpt gpt per_step"] = CKPT_PER_STEP[name]
        if col:
            row["launches_slice22"] = col


# ------------------ slice 23: the monitored step ------------------------------

# phase 5's launches a step of the flash GPT-350M step (fused backward)
MONITOR_PER_STEP = {"flash_attention_fwd": 24, "flash_attention_bwd": 24,
                    "layer_norm_fwd": 49, "layer_norm_bwd": 49, "adam": 1}


def monitored_gpt(torch, remat=False, poison=False):
    """Phase 5's model, optimizer and batch, fresh: GPT-350M (vocab 50304,
    seq 1024, bf16, bf16 logits, flash), seed-0 weights, FusedAdam(lr=
    1e-4, master bf16), tokens from a seed-1 generator at batch 12.
    `poison`: one element of block 7's fc1 weight is inf."""
    from apex_tpu_torch.models import gpt as gpt_mod
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.transformer.training import init_sharded_optimizer

    bf16 = torch.bfloat16
    model = gpt_mod.gpt_350m(vocab_size=50304, seq_len=1024, dropout=0.0,
                             dtype=bf16, logits_dtype=bf16,
                             use_flash_attention=True, remat=remat)
    params = model.init(seed=0)
    if poison:
        params["block7"]["fc1"]["weight"][3, 5] = float("inf")
    opt = FusedAdam(lr=1e-4, master_dtype=bf16)
    state = init_sharded_optimizer(opt, model, params)
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, 50304, (12, 1024), generator=gen,
                           device="cuda", dtype=torch.int32)
    return model, opt, state, (tokens, torch.roll(tokens, -1, dims=1))


def tensor_bytes(torch, obj, seen=None):
    """The bytes of the distinct card storages reachable from `obj`
    through tuples (named ones too), lists and dicts."""
    seen = set() if seen is None else seen
    if isinstance(obj, torch.Tensor):
        key = obj.untyped_storage().data_ptr()
        if obj.is_cuda and key not in seen:
            seen.add(key)
            return obj.untyped_storage().nbytes()
        return 0
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (tuple, list)):
        return sum(tensor_bytes(torch, o, seen) for o in obj)
    return 0


def monitored_step(model, opt, amp_state=None, **kw):
    from apex_tpu_torch.parallel import ddp

    return ddp.make_train_step(lambda p, b: model.loss(p, b[0], b[1]), opt,
                               amp_state=amp_state, **kw)


def flat_distance(torch, a, b):
    return float(torch.linalg.vector_norm(a.float() - b.float()))


def monitor_metrics_leg(torch, tmp, steps=5):
    """(a) 5 monitored steps under a MetricsLogger with a JSONL sink, the
    memory watermarks, a recompile sentry and the step's flops."""
    from apex_tpu_torch import monitor
    from apex_tpu_torch.monitor import flops

    model, opt, state, batch = monitored_gpt(torch)
    step = monitor.RecompileSentry(monitored_step(model, opt, metrics=True),
                                   warn=False)
    name = torch.cuda.get_device_name(0)
    peak = flops.device_peak_flops()
    check("H100" in name and peak in (flops.DEVICE_BF16_PEAKS["h100-sxm"],
                                      flops.DEVICE_BF16_PEAKS["h100-pcie"]),
          f"{name} resolves to a peak of {peak}, not an H100 row")
    fps = flops.gpt_step_flops(model.c, 12)
    path = os.path.join(tmp, "metrics.jsonl")
    lg = monitor.MetricsLogger([monitor.JSONLSink(path)], flops_per_step=fps,
                               memory=True, sentry=step)
    m = monitor.init_metrics()
    torch.cuda.reset_peak_memory_stats()
    recs = []
    for i in range(steps):
        out = step(state, None, batch, m)
        state, m = out[0], out[3]
        recs.append(lg.log_step(m))
        peak_alloc = torch.cuda.max_memory_allocated()
        if i == 0:
            step.mark_steady()
            lg.reset_timer(m)
    lg.close()
    with open(path) as f:
        disk = [json.loads(line) for line in f]
    monitor.validate_records(disk)
    check(len(disk) == steps and [r["step"] for r in disk]
          == list(range(1, steps + 1)), "the JSONL records' steps")
    last = disk[-1]
    check(0.0 < last["mfu"] < 1.0, f"mfu {last['mfu']}")
    # the logger and max_memory_allocated read the same allocator stat, so
    # this one holds the field's name and unit only; the checks after it
    # hold the record against what it does not read itself
    check(abs(last["hbm_peak_bytes_in_use"] - peak_alloc)
          <= 0.01 * peak_alloc, f"hbm_peak_bytes_in_use "
          f"{last['hbm_peak_bytes_in_use']} vs max_memory_allocated "
          f"{peak_alloc}")
    live = tensor_bytes(torch, (state, batch, m))
    total = torch.cuda.get_device_properties(0).total_memory
    check(last["hbm_bytes_limit"] == total, f"hbm_bytes_limit "
          f"{last['hbm_bytes_limit']}, the card's properties {total}")
    check(live <= last["hbm_bytes_in_use"] <= last["hbm_peak_bytes_in_use"]
          <= last["hbm_peak_bytes_reserved"], f"the watermarks "
          f"{ {k: v for k, v in last.items() if k.startswith('hbm_')} } "
          f"against {live} bytes of live state")
    check(last["hbm_bytes_reserved"]
          <= last["hbm_bytes_limit"] - last["hbm_bytes_free"],
          "the allocator holds more than the driver has handed out")
    check(last["n_compiles"] == 1 and "steady_recompiles" not in last,
          "the monitored step's signature changed")
    check(last["tokens_seen"] == 12 * 1024 * steps
          and last["overflow_count"] == 0, "tokens or overflows")
    check(recs[-1]["loss"] < recs[0]["loss"], "the monitored loss did not "
          "fall")
    return {"records": disk, "peak_flops": peak, "flops_per_step": fps,
            "device": name}


def monitor_numbers_leg(torch, fa, ln, ok, steps=3):
    """(b) the traced step makes no host sync, its first loss is the plain
    step's bit for bit, its params after `steps` steps are within 2x the
    distance of two untraced runs, and it launches phase 5's kernels."""
    from apex_tpu_torch import monitor

    def run(**kw):
        model, opt, state, batch = monitored_gpt(torch)
        step = monitored_step(model, opt, **kw)
        extra = (monitor.init_metrics(),) if kw else ()
        losses = []
        for _ in range(steps):
            out = step(state, None, batch, *extra)
            state = out[0]
            losses.append(out[2])
            if kw:
                extra = (out[3],)
        flat = state.params.clone()
        del state, opt
        return flat, losses

    a, la = run()
    b, _ = run()
    t, lt = run(metrics=True, trace=True)
    check(torch.equal(lt[0], la[0]), f"the traced step's first loss "
          f"{float(lt[0])} is not the plain step's {float(la[0])}")
    d_ab, d_ta = flat_distance(torch, a, b), flat_distance(torch, t, a)
    check(d_ta <= 2 * d_ab, f"traced params {d_ta} from the untraced run, "
          f"two untraced runs {d_ab} apart")
    del a, b, t
    torch.cuda.empty_cache()

    model, opt, state, batch = monitored_gpt(torch)
    step = monitored_step(model, opt, metrics=True, trace=True)
    m = monitor.init_metrics()
    holder = {}

    def traced(st, b):
        out = step(st, None, b, holder.get("m", m))
        holder["m"], holder["taps"] = out[3], out[4]
        return out[0], out[2]

    state, _ = traced(state, batch)         # warm-up
    reset_kernel_counts(fa, ln, ok)
    n = 2
    for _ in range(n):
        state, _ = traced(state, batch)
    counts = kernel_counts(fa, ln, ok)
    for k, per in MONITOR_PER_STEP.items():
        check(counts[k] == per * n, f"monitored step {k}: {counts[k]} "
              f"launches in {n} steps, want {per} a step")
    state, syncs = step_without_sync(torch, traced, state, batch)
    return {"first_loss": float(lt[0]), "plain_first_loss": float(la[0]),
            "traced_vs_untraced": d_ta, "untraced_vs_untraced": d_ab,
            "launches_per_step": {k: counts[k] // n
                                  for k in MONITOR_PER_STEP},
            "host_syncs_per_step": len(syncs),
            "metrics_step": int(holder["m"].step)}


def gpt_tap_names(layers=24):
    return [f"block{i}/{p}" for i in range(layers)
            for p in ("ln1", "attn", "ln2", "mlp")]


def monitor_taps_leg(torch):
    """(c) 96 taps in order, both planes finite, and the same with remat
    (no CheckpointError)."""
    from apex_tpu_torch import monitor

    out = {}
    for remat in (False, True):
        model, opt, state, batch = monitored_gpt(torch, remat=remat)
        step = monitored_step(model, opt, metrics=True, trace=True)
        res = step(state, None, batch, monitor.init_metrics())
        ts = res[4]
        check(list(step.tap_names()) == gpt_tap_names(),
              f"remat={remat}: tap names {step.tap_names()[:6]}...")
        check(bool(torch.isfinite(ts.fwd).all())
              and bool(torch.isfinite(ts.grad).all()),
              f"remat={remat}: a tap plane is not finite")
        check(int(ts.first_bad_fwd) == -1 and int(ts.first_bad_grad) == -1,
              f"remat={remat}: a clean step names a bad tap")
        out[f"remat={remat}"] = {
            "n_taps": len(step.tap_names()),
            "fwd_absmax_max": float(ts.fwd[:, 0].max()),
            "grad_absmax_max": float(ts.grad[:, 0].max())}
        del state, opt, res
        torch.cuda.empty_cache()
    return out


def monitor_provenance_leg(torch, tmp):
    """(d) block 7's fc1 weight poisoned with inf under a dynamic loss
    scaler: the forward plane names block7/mlp, the step is skipped (the
    counts rise by 1, the params keep their bits), and a guarded raise
    dumps a report that validates and renders naming block7/mlp."""
    from apex_tpu_torch import amp, monitor
    from apex_tpu_torch.monitor import trace

    bf16 = torch.bfloat16
    model, opt, state, batch = monitored_gpt(torch, poison=True)
    amp_state = amp.initialize(opt_level="O0", loss_scale="dynamic",
                               param_dtype=bf16, compute_dtype=bf16)
    scaler = amp_state.loss_scalers[0]
    step = monitored_step(model, opt, amp_state=amp_state, metrics=True,
                          trace=True)
    m = monitor.init_metrics()
    before = state.params.clone()
    state, scaler, loss, m1, ts = step(state, scaler, batch, m)
    names = step.tap_names()
    prov = trace.provenance(ts, names)
    check(prov is not None and prov["plane"] == "fwd"
          and prov["tap"] == "block7/mlp", f"provenance {prov}")
    check(int(m1.overflow_count) == 1 and int(m1.skipped_steps) == 1
          and int(m1.step) == 1, "the poisoned step was not counted as "
          "skipped")
    check(torch.equal(state.params, before), "the skipped step moved the "
          "params")
    check(float(scaler.scale) == 2.0 ** 15, "the loss scale did not back "
          "off")
    path = os.path.join(tmp, "flight.json")
    rec = trace.FlightRecorder(path, capacity=4, tap_names=names)
    lg = monitor.MetricsLogger([], taps=True)
    rec.record(1, metrics=lg.log_step(m1, taps=ts, tap_names=names), taps=ts)
    try:
        with rec.guard():
            raise RuntimeError("injected crash after the poisoned step")
    except RuntimeError:
        pass
    with open(path) as f:
        rep = json.load(f)
    trace.validate_report(rep)
    text = trace.render_report(rep)
    check("block7/mlp" in text and "first bad step: 1" in text,
          "the rendered report does not name block7/mlp")
    return {"provenance": prov, "loss": float(loss),
            "render_tail": text.splitlines()[-2:]}


def monitor_serve_leg(torch, np, tmp, n_req=8, max_new=8):
    """(e) the flagship engine built with a flight recorder serves a few
    requests; the recorder's dump carries the engine's serve plane and
    its sentry's compile events."""
    from apex_tpu_torch.monitor import trace
    from apex_tpu_torch.serve import build_flagship_engine, measure_decode

    rec = trace.FlightRecorder(os.path.join(tmp, "serve.json"), capacity=4)
    eng = build_flagship_engine(recorder=rec)
    prng = np.random.RandomState(3)
    for _ in range(n_req):
        eng.submit(prng.randint(0, 50304, 16).tolist(), max_new)
    fins = measure_decode(eng, max_steps=8 * max_new)["finished"]
    check(len(fins) == n_req and all(f.status == "ok" for f in fins),
          "the recorded engine did not finish its requests")
    rep = rec.dump()
    trace.validate_report(rep)
    check(rep["serve"] is not None and "fetch_error" not in rep["serve"],
          "the dump has no serve plane")
    check(len(rep["compile_events"]) >= 1 and rep["compile_events"][0][
        "name"] == "serve_decode", "the dump has no sentry compile event")
    del eng
    torch.cuda.empty_cache()
    return {"serve_keys": sorted(rep["serve"]),
            "compile_events": len(rep["compile_events"])}


def monitor_timing_leg(torch):
    """(g) the rank-timing plane over a one-rank NCCL world: the GPT step
    with metrics, taps and rank timing takes its timing vector as a host
    list and makes no host sync, the gathered row on the card is that
    vector; `forward_backward_no_pipelining(rank_timing=)` gathers a host
    list over the NCCL dp group likewise.  The group is torn down
    after."""
    import torch.distributed as dist
    from apex_tpu_torch import monitor
    from apex_tpu_torch.monitor import trace
    from apex_tpu_torch.parallel import mesh
    from apex_tpu_torch.transformer.pipeline_parallel import schedules

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        group = mesh.initialize_model_parallel()
        backend = dist.get_backend(group)
        check(group is not None and backend == "nccl",
              "slice 23 (g): the dp group is not a one-rank NCCL group")
        model, opt, state, batch = monitored_gpt(torch)
        step = monitored_step(model, opt, metrics=True,
                              trace=trace.TraceConfig(rank_timing=True))
        holder = {"m": monitor.init_metrics(), "t": [0.25, 0.125]}

        def timed(st, b):
            out = step(st, None, b, holder["m"], list(holder["t"]))
            holder["m"], holder["rows"] = out[3], out[5]
            return out[0], out[2]

        state, _ = timed(state, batch)          # warm-up
        holder["t"] = [0.5, 0.0625]
        state, syncs = step_without_sync(torch, timed, state, batch)
        rows = holder["rows"]
        check(rows.is_cuda and rows.tolist() == [holder["t"]],
              f"the step's rank timings {rows} are not [{holder['t']}]")
        del state, opt, step
        torch.cuda.empty_cache()

        g = torch.Generator(device="cuda").manual_seed(5)
        w = torch.randn(64, 64, generator=g, device="cuda")
        x = torch.randn(1, 8, 64, generator=g, device="cuda")
        res = schedules.forward_backward_no_pipelining(
            lambda p, mb: (mb @ p["w"]).square().mean(), x, {"w": w},
            num_microbatches=1, rank_timing=[1.5, 0.75])
        fb_rows = res[-1]
        check(fb_rows.is_cuda and fb_rows.tolist() == [[1.5, 0.75]],
              f"forward_backward_no_pipelining's rank timings {fb_rows}")
    finally:
        mesh.destroy_model_parallel()
        dist.destroy_process_group()
    return {"backend": backend, "step_rows": rows.tolist(),
            "host_syncs_per_step": len(syncs),
            "no_pipelining_rows": fb_rows.tolist()}


def monitor_cost_leg(torch, fa, ln, ok, warmup=2, steps=5):
    """(f) a step's wall ms (host clock over `steps` synchronized steps)
    and one profiled step's device ms, with neither plane, with the
    metrics only and with the metrics and the trace."""
    from apex_tpu_torch import monitor

    names = {"flash_attention_fwd": lambda k: "flash_fwd_kernel" in k,
             "flash_attention_bwd": lambda k: "flash_bwd_kernel" in k,
             "layer_norm_fwd": lambda k: "ln_fwd_kernel" in k,
             "layer_norm_bwd": lambda k: "ln_bwd_" in k,
             "adam": lambda k: k == "_adam_kernel"}
    out = {}
    model, opt, state, batch = monitored_gpt(torch)
    for label, kw in (("neither", {}), ("metrics", {"metrics": True}),
                      ("metrics+trace", {"metrics": True, "trace": True})):
        step = monitored_step(model, opt, **kw)
        holder = {"m": monitor.init_metrics()}

        def fn(st, b, step=step, kw=kw, holder=holder):
            res = step(st, None, b, *((holder["m"],) if kw else ()))
            if kw:
                holder["m"] = res[3]
            return res[0], res[2]

        # the counts run from before the warm-up to after the profiled step
        torch.cuda.synchronize()
        reset_kernel_counts(fa, ln, ok)
        for _ in range(warmup):
            state, _ = fn(state, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = fn(state, batch)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / steps
        state, prof = profile_step(torch, fn, state, (batch,), names)
        counts = kernel_counts(fa, ln, ok)
        n = warmup + steps + 1
        for k, per in MONITOR_PER_STEP.items():
            check(counts[k] == per * n, f"{label} step {k}: {counts[k]} "
                  f"launches in {n} steps, want {per} a step")
        out[label] = {"wall_ms": wall, "profiled_wall_ms": prof["wall_ms"],
                      "device_ms": prof["device_ms"],
                      "device_busy_share": prof["device_busy_share"],
                      "aten_elementwise_reduce_copy_ms":
                          prof["aten_elementwise_reduce_copy_ms"],
                      "top_aten_ops_ms": prof["top_aten_ops_ms"],
                      "steps": n,
                      "launches": {k: counts[k] for k in MONITOR_PER_STEP}}
    total = sum(out[label]["steps"] for label in out)
    out["launches"] = {k: sum(v["launches"][k] for v in out.values())
                       for k in MONITOR_PER_STEP}
    out["launches_per_step"] = {k: v / total
                                for k, v in out["launches"].items()}
    return out


def slice23_phase(torch, np, fa, ln, ok, smi):
    """Phase 20 (module docstring): the monitored GPT-350M step, (a)-(f);
    the JSONL and the reports under a temporary directory removed after."""
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_monitor_")
    out = {"card": smi}
    try:
        out["metrics"] = monitor_metrics_leg(torch, tmp)
        log("slice 23 (a) metrics " + json.dumps(
            {k: v for k, v in out["metrics"].items() if k != "records"})
            + " last record " + json.dumps(out["metrics"]["records"][-1]))
        torch.cuda.empty_cache()
        out["numbers"] = monitor_numbers_leg(torch, fa, ln, ok)
        log("slice 23 (b) no sync, same numbers "
            + json.dumps(out["numbers"]))
        torch.cuda.empty_cache()
        out["taps"] = monitor_taps_leg(torch)
        log("slice 23 (c) taps " + json.dumps(out["taps"]))
        out["provenance"] = monitor_provenance_leg(torch, tmp)
        log("slice 23 (d) provenance " + json.dumps(out["provenance"]))
        torch.cuda.empty_cache()
        out["serve"] = monitor_serve_leg(torch, np, tmp)
        log("slice 23 (e) serve plane " + json.dumps(out["serve"]))
        out["timing"] = monitor_timing_leg(torch)
        log("slice 23 (g) rank timing " + json.dumps(out["timing"]))
        torch.cuda.empty_cache()
        out["cost"] = monitor_cost_leg(torch, fa, ln, ok)
        log(f"slice 23 (f) cost on {smi} " + json.dumps(out["cost"]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"phase 20 {time.perf_counter() - t0:.1f}s")
    return out


def add_slice23_columns(rows, slice23):
    """The kernel table's slice-23 column: on each row phase 20's cost leg
    launched, the launches counted there (three step variants, from before
    each warm-up to after its profiled step) and their quotient by the
    steps."""
    cost = slice23["cost"]
    for row in rows:
        name = row["name"]
        if name in cost["launches_per_step"]:
            row["launches_slice23"] = {
                "monitored gpt": cost["launches"][name],
                "monitored gpt per_step": cost["launches_per_step"][name]}


def rate0_bits(root):
    """`python3 chip_smoke.py --rate0-bits ROOT`: digests of the flash
    kernels' outputs at dropout rate 0 from the checkout at ROOT (its
    `apex_tpu_torch` first on sys.path, built into its own
    csrc/build/), for holding two checkouts' kernels bit for bit on one
    card: run it for both in one call and compare the two lines.  The
    launchers are called with the argument lists every checkout's take,
    on seeded bf16 inputs: the forward (o, lse) and the packed forward at
    hp 2, the fused and packed backward's dk and dv, the split pair's dq,
    dk and dv, at GPT's causal (12, 16, 1024, 64), BERT's (32, 16, 512,
    64) with ragged padding and head_dim 128 (2, 8, 512, 128).  The fused
    and packed kernels' dq is summed by reduce-adds in an order that
    changes from run to run, so it is left out.  Prints {case: {output:
    sha256 of its bytes}}."""
    import hashlib

    sys.path.insert(0, os.path.abspath(root))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    from apex_tpu_torch.ops import flash_attention as fa

    def digest(t):
        return hashlib.sha256(
            t.contiguous().view(torch.uint8).cpu().numpy().tobytes()
        ).hexdigest()[:16]

    out = {"root": os.path.abspath(fa.__file__)}
    for name, (b, h, s, d), causal, padded in (
            ("gpt", (12, 16, 1024, 64), True, False),
            ("bert", (BERT_BATCH, 16, BERT_SEQ, 64), False, True),
            ("d128", (2, 8, 512, 128), True, False)):
        g = torch.Generator(device="cuda").manual_seed(20 + b)
        q, k, v, do = (torch.randn((b, h, s, d), generator=g, device="cuda")
                       .to(torch.bfloat16) for _ in range(4))
        seg = ()
        if padded:
            n = torch.tensor([(512, 300, 129, 1)[i % 4] for i in range(b)],
                             device="cuda")
            ids = (torch.arange(s, device="cuda")[None, :]
                   < n[:, None]).to(torch.int32)
            seg = (ids, ids)
        sc = 1.0 / math.sqrt(d)
        o, lse = fa.flash_fwd_cuda(q, k, v, sc, causal, *seg)
        po, plse = fa.flash_fwd_packed_cuda(q, k, v, sc, causal, 2, *seg)
        delta = torch.sum(do.float() * o.float(), dim=-1)
        args = (q, k, v, do, lse, delta, sc, causal)
        _, dk, dv = fa.flash_bwd_cuda(*args, *seg)
        _, pdk, pdv = fa.flash_bwd_packed_cuda(*args, 2, *seg)
        sdq = fa.flash_bwd_dq_cuda(*args, *seg)
        sdk, sdv = fa.flash_bwd_dkv_cuda(*args, *seg)
        torch.cuda.synchronize()
        out[name] = {key: digest(t) for key, t in (
            ("o", o), ("lse", lse), ("packed_o", po), ("packed_lse", plse),
            ("dk", dk), ("dv", dv), ("packed_dk", pdk), ("packed_dv", pdv),
            ("split_dq", sdq), ("split_dk", sdk), ("split_dv", sdv))}
    print(json.dumps(out, sort_keys=True), flush=True)
    return 0


def resnet_steps_main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    from apex_tpu_torch import csrc
    from apex_tpu_torch.ops import optimizer_kernels as ok
    from apex_tpu_torch.ops import welford as wf
    from apex_tpu_torch.ops import xentropy as xe

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)
    csrc.build(["welford"])
    return resnet_steps_evidence(torch, xe, wf, ok)


def main():
    """Pin the tuner's cache to a fresh file for the whole run (a cache
    elsewhere, e.g. under ~/.cache, must not change any phase's kernels;
    phase 11's sweep writes its winner there), then run the phases.
    `--rate0-bits ROOT` runs `rate0_bits` instead, `--resnet-steps`
    `resnet_steps_evidence`."""
    if sys.argv[1:2] == ["--rate0-bits"]:
        return rate0_bits(sys.argv[2])
    if sys.argv[1:2] == ["--resnet-steps"]:
        return resnet_steps_main()
    tune_dir = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    os.environ["APEX_TPU_TUNE_CACHE"] = os.path.join(tune_dir, "tune.json")
    os.environ.pop("APEX_TPU_TUNE", None)
    try:
        return run_phases()
    finally:
        shutil.rmtree(tune_dir, ignore_errors=True)


def run_phases():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2

    from apex_tpu_torch import csrc
    from apex_tpu_torch.ops import flash_attention as fa
    from apex_tpu_torch.ops import flash_decode as fd
    from apex_tpu_torch.ops import fused_dense as fdn
    from apex_tpu_torch.ops import layer_norm as ln
    from apex_tpu_torch.ops import optimizer_kernels as ok
    from apex_tpu_torch.ops import softmax as sm
    from apex_tpu_torch.ops import welford as wf
    from apex_tpu_torch.ops import xentropy as xe
    from apex_tpu_torch.ops._common import strict_matmul_numerics
    from apex_tpu_torch.serve import engine as engine_mod
    from apex_tpu_torch.serve import build_flagship_engine, measure_decode

    t_start = time.perf_counter()
    strict_matmul_numerics()

    # ---- 1. device + build -------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    sources = ["flash_decode", "flash_attention", "fused_dense",
               "layer_norm", "welford", "launch_floor"]
    csrc.build(sources)                 # one nvcc per source, in parallel
    log(f"nvcc build {time.perf_counter() - t0:.1f}s")
    for name in sources:
        if os.path.exists(csrc.log_path(name)):
            with open(csrc.log_path(name)) as f:
                lines = [ln_.strip() for ln_ in f
                         if "registers" in ln_ or "spill" in ln_
                         or "Compiling entry" in ln_
                         or "Performance Loss" in ln_]
            # ptxas notes that it serialised wgmma instructions (C7515):
            # the kernel is right but slow
            for ln_ in lines:
                if "Performance Loss" in ln_:
                    log(f"ptxas {name}: " + ln_[:200])
            if name == "fused_dense":   # 64 instantiations: a summary
                fams, spills = fused_dense_ptxas(lines)
                log(f"ptxas {name}: " + ", ".join(
                    f"{f} {len(r)} kernels, registers {min(r)}-{max(r)}"
                    for f, r in sorted(fams.items()))
                    + f"; spills: {spills or 'none'}; fp32 kernel "
                    f"clusters of 1..8 blocks held at once "
                    f"{fdn.f32_clusters(torch.device('cuda', 0))}")
                check(all(f in fams for f in ("f32", "gemv", "mma",
                                              "wgmma")),
                      f"fused dense ptxas: kernel families {sorted(fams)}")
                check(not any(f in ("f32", "gemv") for f, _ in spills),
                      f"fused dense: the fp32 or GEMV kernel spills: "
                      f"{spills}")
                continue
            if name in ("layer_norm", "flash_decode", "welford"):
                # this slice's kernels: a summary line, and no spills
                regs, spills = small_kernel_ptxas(lines)
                log(f"ptxas {name}: registers by kernel {regs}; spills: "
                    f"{spills or 'none'}")
                check(regs and not spills, f"{name}: a kernel spills: "
                      f"{spills}")
                continue
            for line in lines:
                log(f"ptxas {name}: " + line[:160])
            if name == "flash_attention":
                with open(csrc.log_path(name)) as f:
                    rows, smem, notes = bwd_ptxas(fa, f.read())
                for kname, r in sorted(rows.items()):
                    log(f"ptxas flash backward {kname[-60:]}: {r}")
                log(f"flash backward dynamic shared memory (bytes): {smem}")
                log("flash backward serialised wgmma notes: "
                    + ("; ".join(notes) if notes else "none"))
                # the dq pass: sixteen instantiations (eight with
                # dropout, eight with fp32 dq), none spilling, none with
                # its wgmma instructions serialised
                dq_rows = {k: r for k, r in rows.items()
                           if "flash_bwd_dq_kernel" in k}
                check(len(dq_rows) == 16 and all(
                    r.get("spills", "").startswith(
                        "0 bytes stack frame, 0 bytes spill")
                    for r in dq_rows.values()),
                    f"dq pass ptxas: {dq_rows}")
                check(not any("flash_bwd_dq_kernel" in n_ for n_ in notes),
                      "dq pass: ptxas serialised its wgmma instructions")
                # the 24 dropout instantiations: no spill, and no
                # serialised-wgmma note that the rate-0 twin lacks
                with open(csrc.log_path(name)) as f:
                    drop_regs = check_dropout_ptxas(f.read())
                log("ptxas flash dropout instantiations, registers (rate "
                    "0's): " + json.dumps(
                        {k[-48:]: r for k, r in sorted(drop_regs.items())}))
                # the 24 fp32-output instantiations: no spill, and no
                # serialised-wgmma note that the bf16 twin lacks
                with open(csrc.log_path(name)) as f:
                    f32_regs = check_f32_ptxas(f.read())
                log("ptxas flash fp32-output instantiations, registers "
                    "(bf16 twin's): " + json.dumps(
                        {k[-48:]: r for k, r in sorted(f32_regs.items())}))

    # ---- 2. kernels vs plain -----------------------------------------
    rng = torch.Generator(device="cuda").manual_seed(1234)
    errs = {}
    bf16, f32 = torch.bfloat16, torch.float32
    fd_main = decode_main_case(torch, rng)
    errs["flash_decode"] = check_flash_decode(torch, fd, fd_main, bf16)
    main_plan = fd.flash_decode_cuda.last_plan
    check(main_plan.split == 1 and main_plan.row_tile == 1,
          f"flash_decode main shape plan {main_plan}")
    # heads_per_step 1, 2 and 4 give the plan's bits; 8 and 16 leave
    # fewer blocks, so the plan may split (another merge order): those
    # are held against the plain version instead
    q, k, v, tbl, lens = fd_main
    want = fd.flash_decode_cuda(q, k, v, tbl, lens, 0.125)
    hp_errs = {}
    for hp in (1, 2, 4, 8, 16):
        got = fd.flash_decode_cuda(q, k, v, tbl, lens, 0.125, hp)
        plan = fd.flash_decode_cuda.last_plan
        check(plan.heads_per_block == hp,
              f"flash_decode heads_per_step={hp}: plan {plan}")
        if plan.split == main_plan.split:
            check(torch.equal(got, want),
                  f"flash_decode heads_per_step={hp}: other bits")
        else:
            check(hp > 4, f"flash_decode heads_per_step={hp}: plan {plan}")
            hp_errs[f"hp={hp} split={plan.split}"] = check_flash_decode(
                torch, fd, fd_main, bf16, hp)
    log(f"flash_decode main shape: plan {tuple(main_plan)}; "
        f"heads_per_step of the same split bit for bit with it; the "
        f"others' max err vs plain {hp_errs}")
    fd_long = decode_long_case(torch, rng)
    e = check_flash_decode(torch, fd, fd_long, bf16)
    long_plan = fd.flash_decode_cuda.last_plan
    check(long_plan.split > 1, f"flash_decode long case plan {long_plan}")
    log(f"flash_decode long case (4 slots x 16 heads x 4096 keys) bf16: "
        f"plan {tuple(long_plan)}, max err {e:.3e}")
    for dtype in (f32, bf16):
        for d in (64, 128):
            case = flash_decode_case(
                torch, rng, n_slots=4, hkv=2, G=2, q_len=2, d=d, page=16,
                max_pages=4, n_pages=17, lengths=[0, 5, 32, 64], dtype=dtype)
            e = check_flash_decode(torch, fd, case, dtype)
            log(f"flash_decode GQA G=2 q_len=2 d={d} {dtype}: plan "
                f"{tuple(fd.flash_decode_cuda.last_plan)}, max err {e:.3e}")
    # 16 query rows per kv head (two row tiles), page 8, and a length
    # past the table's capacity (40 positions)
    case = flash_decode_case(
        torch, rng, n_slots=5, hkv=2, G=8, q_len=2, d=64, page=8,
        max_pages=5, n_pages=26, lengths=[0, 3, 17, 40, 45], dtype=f32)
    e = check_flash_decode(torch, fd, case, f32)
    log(f"flash_decode GQA G=8 q_len=2 page=8 float32: plan "
        f"{tuple(fd.flash_decode_cuda.last_plan)}, max err {e:.3e}")
    log(f"flash_decode main shape bf16: max err {errs['flash_decode']:.3e}")
    errs["layer_norm"] = layer_norm_fwd_checks(torch, ln, rng)
    # the training path: flash attention at the step's shape (q, k, v
    # strided views of the packed qkv, do a permuted view), then ragged
    # sequences and head_dim 128
    e = check_flash_attention(torch, fa, rng, b=12, h=16, s=1024, d=64,
                              causal=True, packed=True)
    errs["flash_attention_fwd"] = e["o"]
    errs["flash_attention_bwd"] = max(e["dq"], e["dk"], e["dv"])
    log(f"flash_attention (12,16,1024,64) causal, packed: {e}")
    for b_, h_, s_, d_, causal in ((2, 3, 200, 64, True),
                                   (2, 3, 200, 64, False),
                                   (1, 2, 129, 128, True),
                                   (1, 2, 77, 128, False)):
        e = check_flash_attention(torch, fa, rng, b=b_, h=h_, s=s_, d=d_,
                                  causal=causal)
        log(f"flash_attention ({b_},{h_},{s_},{d_}) causal={causal}: {e}")
    # sq != sk, sk off the backward's 128-key tile (causal with sq < sk:
    # key tiles no query sees)
    for b_, h_, sq_, sk_, d_, causal in ((2, 4, 100, 300, 64, True),
                                         (2, 4, 300, 200, 64, False),
                                         (1, 4, 77, 200, 128, True),
                                         (1, 4, 330, 129, 128, False)):
        e = check_flash_cross(torch, fa, rng, b=b_, h=h_, sq=sq_, sk=sk_,
                              d=d_, causal=causal)
        log(f"flash_attention sq={sq_} sk={sk_} d={d_} causal={causal}: "
            f"dk, dv bit for bit fused / dk/dv pass / packed; {e}")
        e = check_dq_pass(torch, fa, rng, b=b_, h=h_, sq=sq_, sk=sk_, d=d_,
                          causal=causal)
        log(f"dq pass sq={sq_} sk={sk_} d={d_} causal={causal}: max err "
            f"{e:.3e} vs its plain version, two runs bit for bit")
    # the GPT and BERT steps' rows, ragged and tiny ones, fp16, RMSNorm,
    # no weight, a g 4 bytes off 16 (4-byte loads), an odd fp16 width
    # (2-byte loads), rows of 2-12 warps
    _, errs["layer_norm_bwd"] = check_layer_norm_bwd(torch, ln, rng, 12288,
                                                     1024, bf16)
    f16 = torch.float16
    for rows, hidden, dtype, kw in (
            (16384, 1024, bf16, {}), (77, 1000, f32, {}), (5, 1024, bf16, {}),
            (64, 1024, f16, {}), (12288, 1024, bf16, {"rms": True}),
            (12288, 1024, bf16, {"weight": False}),
            (77, 1000, f32, {"offset": 1}), (77, 1001, f16, {}),
            (33, 2048, f32, {}), (9, 4096, bf16, {"rms": True}),
            (3, 16384, bf16, {}), (3, 16384, f32, {})):
        plan, e = check_layer_norm_bwd(torch, ln, rng, rows, hidden, dtype,
                                       **kw)
        log(f"layer_norm bwd ({rows},{hidden}) {dtype} {kw}: plan "
            f"{tuple(plan)}, max dx err {e:.3e}, two runs bit for bit")
    n_flat = 354_877_440             # GPT-350M, FLAT_TILE-padded
    errs["adam"] = check_adam(torch, ok, rng, n_flat, bf16, 0.0)
    e = check_adam(torch, ok, rng, 1_000_003, f32, 0.01)
    log(f"adam ({n_flat},) bf16: max err {errs['adam']:.3e}; "
        f"(1000003,) fp32 AdamW: {e:.3e}")
    torch.cuda.empty_cache()
    # the BERT path: segment-masked flash at the step's shape (packed
    # views, ragged padding), causal on top, rows with every key masked,
    # and small ragged shapes; then the LAMB kernels
    bseg = pad_segments(torch, BERT_BATCH, BERT_SEQ, [512, 300, 129, 1])
    e = check_flash_attention(torch, fa, rng, b=BERT_BATCH, h=16,
                              s=BERT_SEQ, d=64, causal=False, packed=True,
                              q_seg=bseg, kv_seg=bseg)
    errs["flash_attention_fwd_seg"] = e["o"]
    errs["flash_attention_bwd_seg"] = max(e["dq"], e["dk"], e["dv"])
    log(f"flash_attention segments (32,16,512,64), packed: {e}")
    e = check_flash_attention(torch, fa, rng, b=BERT_BATCH, h=16,
                              s=BERT_SEQ, d=64, causal=True, q_seg=bseg,
                              kv_seg=bseg)
    log(f"flash_attention segments + causal (32,16,512,64): {e}")
    gq = torch.Generator(device="cuda").manual_seed(5)
    qs = torch.randint(0, 4, (BERT_BATCH, BERT_SEQ), generator=gq,
                       device="cuda", dtype=torch.int32)
    ks = torch.randint(0, 3, (BERT_BATCH, BERT_SEQ), generator=gq,
                       device="cuda", dtype=torch.int32)
    e = check_flash_attention(torch, fa, rng, b=BERT_BATCH, h=16,
                              s=BERT_SEQ, d=64, causal=False, q_seg=qs,
                              kv_seg=ks)
    check(e["dead_rows"] > 0, "no fully masked row in the q/kv id case")
    log(f"flash_attention q/kv segment ids, whole rows masked: {e}")
    for b_, s_, d_, causal, lens in ((2, 200, 64, False, [200, 77]),
                                     (3, 129, 128, True, [129, 64, 1])):
        sg = pad_segments(torch, b_, s_, lens)
        e = check_flash_attention(torch, fa, rng, b=b_, h=3, s=s_, d=d_,
                                  causal=causal, q_seg=sg, kv_seg=sg)
        log(f"flash_attention segments ({b_},3,{s_},{d_}) causal={causal} "
            f"lengths {lens}: {e}")
    # head_dim 128 with BERT's ragged padding, on the step's views, and a
    # query whose id no key carries (a dead row: uniform p, ds = 0)
    sg = pad_segments(torch, 4, BERT_SEQ, [512, 300, 129, 1])
    qd = sg.clone()
    qd[1, 400] = 5
    e = check_flash_attention(torch, fa, rng, b=4, h=8, s=BERT_SEQ, d=128,
                              causal=False, packed=True, q_seg=qd,
                              kv_seg=sg)
    check(e["dead_rows"] == 8, f"d=128 padding case: {e['dead_rows']} "
          f"dead rows, want 8 (one a head)")
    log(f"flash_attention segments (4,8,512,128), packed, a dead row: {e}")
    # the dq pass with segment ids: the same d=128 padding and dead row,
    # BERT's step shape with its padding, and q/kv ids that leave whole
    # rows masked
    for kw in (dict(b=4, h=8, sq=BERT_SEQ, sk=BERT_SEQ, d=128,
                    causal=False, q_seg=qd, kv_seg=sg),
               dict(b=BERT_BATCH, h=16, sq=BERT_SEQ, sk=BERT_SEQ, d=64,
                    causal=False, q_seg=bseg, kv_seg=bseg),
               dict(b=BERT_BATCH, h=16, sq=BERT_SEQ, sk=BERT_SEQ, d=64,
                    causal=True, q_seg=bseg, kv_seg=bseg),
               dict(b=BERT_BATCH, h=16, sq=BERT_SEQ, sk=BERT_SEQ, d=64,
                    causal=False, q_seg=qs, kv_seg=ks)):
        e = check_dq_pass(torch, fa, rng, **kw)
        log(f"dq pass segments ({kw['b']},{kw['h']},{kw['sq']},{kw['d']}) "
            f"causal={kw['causal']}: max err {e:.3e} vs its plain version, "
            f"two runs bit for bit")
    del sg, qd
    # the packed pair (hp heads a block) against the hp=1 kernels and the
    # plain version: GPT's step shape on its views, BERT's with ragged
    # padding and with q/kv ids that leave whole rows masked, head_dim 128
    packed_errs = []
    for kw in (dict(b=12, h=16, s=1024, d=64, causal=True, views=True),
               dict(b=BERT_BATCH, h=16, s=BERT_SEQ, d=64, causal=False,
                    views=True, q_seg=bseg, kv_seg=bseg),
               dict(b=BERT_BATCH, h=16, s=BERT_SEQ, d=64, causal=False,
                    q_seg=qs, kv_seg=ks),
               dict(b=2, h=8, s=512, d=128, causal=True),
               dict(b=3, h=8, s=129, d=128, causal=False,
                    q_seg=pad_segments(torch, 3, 129, [129, 64, 1]),
                    kv_seg=pad_segments(torch, 3, 129, [129, 64, 1])),
               # past the forward's resident key ids (8192): staged ids
               dict(b=2, h=2, s=8256, d=64, causal=False,
                    q_seg=pad_segments(torch, 2, 8256, [8256, 5000]),
                    kv_seg=pad_segments(torch, 2, 8256, [8256, 5000]))):
        e = check_packed_flash(torch, fa, rng,
                               hps=tuple(hp for hp in (2, 4)
                                         if kw["h"] % hp == 0), **kw)
        packed_errs.append(e)
        log(f"packed flash ({kw['b']},{kw['h']},{kw['s']},{kw['d']}) "
            f"causal={kw['causal']} ids={kw.get('q_seg') is not None}: "
            f"bit for bit with hp=1 (o, lse, dk, dv); {e}")
    errs["flash_attention_fwd_packed"] = packed_errs[0][2]["o"]
    errs["flash_attention_bwd_packed"] = max(
        packed_errs[0][2][n] for n in ("dq", "dk", "dv"))
    # dropout inside the six flash kernels (phase 12's path): each
    # kernel's mask read back against dropout_keep_dense, bit for bit, then
    # every kernel at rates 0.1 and 0.5 against its plain version
    shares = {}
    for d_, offs in ((64, (0, 0)), (64, (4096, 0)), (128, (77, 1 << 20))):
        for rate in DROP_RATES:
            shares[f"d={d_} offs={offs} rate={rate}"] = check_dropout_mask(
                torch, fa, b=2, h=4, d=d_, rate=rate, q_off=offs[0],
                k_off=offs[1])
    log("flash dropout masks (forward, packed forward, fused and dk/dv dv, "
        "dq pass and fused dq) bit for bit dropout_keep_dense; keep shares "
        + json.dumps(shares))
    drop_errs = {}
    for name, kw in (
            ("gpt", dict(b=12, h=16, s=1024, d=64, causal=True, hps=(2, 4),
                         views=True)),
            ("non-causal", dict(b=8, h=16, s=2048, d=64, causal=False,
                                hps=(2, 4))),
            ("d128", dict(b=2, h=8, s=512, d=128, causal=True, hps=(2, 4))),
            ("bert", dict(b=BERT_BATCH, h=16, s=BERT_SEQ, d=64, causal=False,
                          hps=(2, 4), views=True, q_seg=bseg, kv_seg=bseg)),
            ("split", dict(b=1, h=16, s=8192, d=64, causal=True,
                           split=True)),
            ("q_off 4096", dict(b=2, h=16, s=1024, d=64, causal=True,
                                q_off=4096, hps=(2,), split=True))):
        drop_errs[name] = check_flash_dropout(torch, fa, rng, **kw)
        log(f"flash dropout {name} {kw.get('b')},{kw.get('h')},"
            f"{kw.get('s')},{kw.get('d')}: runs bit for bit, packed bit for "
            f"bit hp=1; max errs {json.dumps(drop_errs[name])}")
    gpt_e, split_e = drop_errs["gpt"][0.1], drop_errs["split"][0.1]
    errs["flash_attention_fwd_dropout"] = gpt_e["o"]
    errs["flash_attention_bwd_dropout"] = max(gpt_e[n] for n in
                                              ("dq", "dk", "dv"))
    # the packed kernels' o, dk, dv are the hp=1 kernels' bits
    errs["flash_attention_fwd_packed_dropout"] = gpt_e["o"]
    errs["flash_attention_bwd_packed_dropout"] = max(
        gpt_e["dk"], gpt_e["dv"], gpt_e["dq_hp2_vs_hp1"] + gpt_e["dq"])
    errs["flash_attention_bwd_dq_dropout"] = split_e["dq_pass"]
    errs["flash_attention_bwd_dkv_dropout"] = max(split_e["dk"],
                                                  split_e["dv"])
    del bseg, qs, ks
    # slice 20: the backward kernels with fp32 outputs (the ring's chunks)
    f32_errs = f32_checks(torch, fa, rng)
    log("flash fp32 gradients (bf16 launches = fp32 rounded, bit for bit; "
        "each fp32 launch twice the same bits; the dk/dv pass the fused "
        "kernel's) max errs vs the plain fp32 versions "
        + json.dumps(f32_errs))
    log("packed forward with unpacked backward routes "
        + json.dumps(check_packed_routes(torch, fa, ln, ok, rng)))
    ew = check_elementwise(torch, ok, rng)
    errs["elementwise"] = max(ew["axpy"], ew["adam"])
    errs["elementwise_launches"] = ew["launches"]
    log(f"elementwise ({EW_N},) fp32, axpy and Adam-shaped: bit for bit "
        f"with the plain versions ({ew['launches']} launches)")
    torch.cuda.empty_cache()
    layout = bert_large_layout(torch)
    for dtype in (bf16, f32):
        e = check_lamb(torch, ok, rng, *layout, dtype)
        log(f"lamb ({layout[1]},) {dtype}: max errs {e}")
        if dtype == bf16:
            errs.update(e)
    torch.cuda.empty_cache()
    # the ResNet path: the cross entropy at the step's (256, 1000) fp32
    # logits with and without smoothing and at a ragged vocabulary, SGD
    # over the ResNet-50 flat buffer, the channel sums at the step's
    # largest and smallest batch-norm shapes and a ragged one
    for rows, v, eps, dtype in ((256, 1000, 0.0, f32), (256, 1000, 0.1, f32),
                                (64, 50304, 0.0, f32), (64, 50304, 0.1, bf16),
                                (7, 37, 0.1, f32)):
        e = check_xent(torch, xe, rng, rows, v, eps, dtype)
        log(f"xentropy ({rows},{v}) eps={eps} {dtype}: max errs fwd "
            f"{e[0]:.3e} bwd {e[1]:.3e}")
        if (rows, v, eps) == (256, 1000, 0.0):
            errs["xent_fwd"], errs["xent_bwd"] = e
    errs["sgd"], exact = check_sgd(torch, ok, rng, RESNET50_FLAT)
    log(f"sgd ({RESNET50_FLAT},) fp32/bf16 grads: max err {errs['sgd']:.3e}, "
        f"bit for bit {exact}")
    errs["channel_sums"] = channel_sums_checks(torch, wf, rng)
    torch.cuda.empty_cache()
    errs.update(dense_kernel_checks(torch, sm, rng))
    gpt_layout = gpt350m_layout(torch)
    for dtype in (bf16, f32):
        e = check_adam_seg(torch, ok, rng, *gpt_layout, dtype)
        log(f"adam_flat_seg ({gpt_layout[1]},) {dtype}: bit for bit, max "
            f"err {e:.3e}")
        if dtype == bf16:
            errs["adam_seg"] = e
    # slice 17: the segmented kernels at a ZeRO shard's row offset, four
    # virtual shards of each layout launched one after another
    shards = {name: check_virtual_shards(torch, ok, rng, *lay, name)
              for name, lay in (("GPT-350M", gpt_layout),
                                ("BERT-Large", layout))}
    log("virtual shards (4 of each flat buffer, each launch bit for bit its "
        "plain version, the concatenation the whole-buffer launch) "
        + json.dumps(shards))
    # this slice's kernels: Adagrad over the GPT-350M buffer, the
    # per-element LAMB phase 2 over the BERT-Large buffer, the fused
    # dense GEMM at GPT-350M's MLP shapes, apex's run_mlp layers and
    # ragged shapes
    errs["adagrad"] = check_adagrad(torch, ok, rng, gpt_layout[1])
    log(f"adagrad ({gpt_layout[1]},) bf16 and fp32 grads, L2 and "
        f"decoupled wd: bit for bit")
    for dtype in (bf16, f32):
        e = check_lamb_phase2_flat(torch, ok, rng, layout[0], layout[1],
                                   dtype)
        log(f"lamb_phase2_flat ({layout[1]},) {dtype}: bit for bit with "
            f"its plain version and lamb_phase2_seg")
        if dtype == bf16:
            errs["lamb_phase2_flat"] = e
    torch.cuda.empty_cache()
    errs["fused_dense"] = 0.0
    for route in ("fma", "gemv", "mma"):
        errs[f"fused_dense_{route}"] = 0.0
    for m_, k_, n_ in GEMM_SHAPES:
        for dtype in (bf16, torch.float16, f32):
            route, e = check_fused_dense(torch, fdn, rng, m_, k_, n_, dtype)
            log(f"fused_dense ({m_},{k_})x({k_},{n_}) {dtype} {route} "
                f"{fdn.linear_bias_cuda.last_plan}, 4 activations x bias: "
                f"max err {e:.3e} of the largest |y|")
            if m_ == 12288 and dtype == bf16:
                errs["fused_dense"] = max(errs["fused_dense"], e)
            if route != "wgmma":
                errs[f"fused_dense_{route}"] = max(
                    errs[f"fused_dense_{route}"], e)
    torch.cuda.empty_cache()

    # ---- 3. the engine at full width ---------------------------------
    eng = build_flagship_engine()
    c, s = eng.model_cfg, eng.serve_cfg
    check((c.vocab_size, c.hidden, c.num_layers, c.num_heads, c.dtype,
           s.n_slots, eng.kv_config.page_size, eng.kv_config.n_pages)
          == (50304, 1024, 24, 16, bf16, 64, 128, 65),
          "flagship configuration drifted")
    prng = np.random.RandomState(0)
    n_req, max_new = 64, 32
    for _ in range(n_req):
        plen = int(prng.randint(1, s.max_prompt_len + 1))
        eng.submit(prng.randint(0, c.vocab_size, plen).tolist(), max_new)
    fd.flash_decode_cuda.launches = 0
    ln.norm_fwd_cuda.launches = 0
    m = measure_decode(eng, max_steps=16 * max_new + 64)
    launches = {"flash_decode": fd.flash_decode_cuda.launches,
                "layer_norm": ln.norm_fwd_cuda.launches}
    decode_steps = eng.sentry.calls
    prefills = eng.prefills
    fins = m["finished"]
    phase3_tokens = {f.request_id: f.tokens for f in fins}
    check(len(fins) == n_req, f"{len(fins)} of {n_req} requests finished")
    check(all(f.status == "ok" for f in fins), "a request did not end ok")
    check(all(len(f.tokens) == max_new for f in fins),
          "a request's token count is not its budget")
    check(all(0 <= t < c.vocab_size for f in fins for t in f.tokens),
          "token id out of vocab")
    check(m["recompile_ok"], f"recompile: {eng.sentry.summary()}")
    check(prefills == n_req == m["admitted"], f"prefills {prefills}")
    check(launches["flash_decode"] == c.num_layers * decode_steps > 0,
          f"flash_decode launches {launches['flash_decode']} != "
          f"{c.num_layers} x {decode_steps} decode steps")
    n_ln = 2 * c.num_layers + 1
    check(launches["layer_norm"] == n_ln * (decode_steps + prefills),
          f"layer_norm launches {launches['layer_norm']} != {n_ln} x "
          f"({decode_steps} decode steps + {prefills} prefills)")
    check(eng.cache.free_pages == eng.kv_config.usable_pages,
          "pool not drained")
    led = m["ledger"]
    engine_line = {
        "decode_tokens_per_s": m["tokens_per_sec"],
        "token_p50_ms": m["p50_ms"], "token_p99_ms": m["p99_ms"],
        "ttft_p50_ms": 1e3 * led["ttft_s"]["p50"],
        "ttft_p99_ms": 1e3 * led["ttft_s"]["p99"],
        "steps": m["steps"], "decode_steps": decode_steps,
        "prefills": prefills, "pure_decode_steps": m["pure_decode_steps"],
        "launches": launches,
        "logits_mm_out_dtype": eng._logits_out_dtype,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    log("engine " + json.dumps(engine_line))
    params = eng.params
    del eng
    log("decode step profile " + json.dumps(
        profile_decode(torch, np, build_flagship_engine, params)))

    # ---- 4. churn == solo, bitwise; kernel step == plain step --------
    crng = np.random.RandomState(1)
    prompts = [crng.randint(0, c.vocab_size,
                            int(crng.randint(1, 129))).tolist()
               for _ in range(8)]
    budgets = [4, 9, 3, 7, 12, 2, 8, 5]
    churn_eng = build_flagship_engine(n_slots=4, params=params)
    rids = [churn_eng.submit(p, b) for p, b in zip(prompts, budgets)]
    churn = {f.request_id: f.tokens for f in churn_eng.run()}
    check(churn_eng.recompile_ok and churn_eng.cache.free_pages
          == churn_eng.kv_config.usable_pages, "churn engine not drained")
    solo_eng = build_flagship_engine(n_slots=4, params=params)
    for i, (p, b) in enumerate(zip(prompts, budgets)):
        solo_eng.submit(p, b)
        solo = solo_eng.run()[0].tokens
        check(solo == churn[rids[i]],
              f"stream {i}: churn {churn[rids[i]]} != solo {solo}")
    check(solo_eng.cache.free_pages == solo_eng.kv_config.usable_pages,
          "solo engine not drained")
    log("churn == solo: 8 streams bitwise equal")

    step_eng = build_flagship_engine(
        n_slots=4, params=params, serve_overrides={"emit_logits": True})
    for p in prompts[:4]:
        step_eng.submit(p, 8)
    step_eng.step()

    def one_step():
        kv = {k: v.clone() for k, v in step_eng.kv.items()}
        st = step_eng.state._replace(
            **{k: v.clone() for k, v in step_eng.state._asdict().items()})
        with torch.inference_mode():
            return step_eng.decode_step(step_eng.params, kv, st)[2]

    logits_k = one_step()
    plain_fd = (lambda *a, softmax_scale=None:
                fd.paged_attention_reference(*a, softmax_scale=softmax_scale))
    saved = engine_mod.flash_decode, engine_mod.fused_layer_norm
    engine_mod.flash_decode = plain_fd
    engine_mod.fused_layer_norm = ln.layer_norm_reference
    try:
        logits_p = one_step()
    finally:
        engine_mod.flash_decode, engine_mod.fused_layer_norm = saved
    torch.cuda.synchronize()
    step_err = (logits_k - logits_p).abs().max().item()
    scale = logits_p.abs().max().item()
    agree = (logits_k.argmax(-1) == logits_p.argmax(-1)).float().mean().item()
    log(f"decode step, kernels vs plain versions: max |dlogit| "
        f"{step_err:.4e} of max |logit| {scale:.4e}; argmax agreement "
        f"{agree:.2f}")
    check(math.isfinite(step_err) and step_err <= 0.05 * scale,
          "decode step through the kernels disagrees with the plain step")
    del step_eng, churn_eng, solo_eng, params, logits_k, logits_p
    torch.cuda.empty_cache()

    # ---- 5. the training step at full width --------------------------
    train, train_vs_plain = train_phase(torch, fa, ln, ok)
    log("train " + json.dumps(train))
    torch.cuda.empty_cache()

    # ---- 6. the BERT-Large step at full width -------------------------
    bert, bert_vs_plain = bert_phase(torch, fa, ln, ok)
    log("bert " + json.dumps(bert))
    torch.cuda.empty_cache()

    # ---- 7. the ResNet-50 AMP-O1 step at full width -------------------
    resnet, resnet_vs_plain, resnet_spec = resnet_phase(torch, xe, wf, ok)
    log("resnet " + json.dumps(resnet))
    torch.cuda.empty_cache()

    # ---- 8. the dense-attention steps at full width ---------------------
    dense_gpt, dense_bert, dense_gpt_vs_plain, dense_bert_vs_plain = (
        dense_phase(torch, fa, ln, ok))
    torch.cuda.empty_cache()

    # ---- 9. the long-context step: the split backward -----------------
    long, long_vs_plain = long_phase(torch, fa, ln, ok, rng)
    torch.cuda.empty_cache()

    # ---- 10. this slice's legs ---------------------------------------
    adagrad, adagrad_vs_plain = adagrad_phase(torch, fa, ln, ok)
    log("adagrad GPT " + json.dumps(adagrad))
    torch.cuda.empty_cache()
    larc, _, _ = resnet_phase(torch, xe, wf, ok, steps=3, larc=True)
    log("LARC resnet " + json.dumps(larc))
    torch.cuda.empty_cache()
    novograd = novograd_phase(torch, fa, ln, ok)
    log("novograd BERT " + json.dumps(novograd))
    fdn.linear_bias_cuda.launches = 0
    for route in fdn.linear_bias_cuda.route_launches:
        fdn.linear_bias_cuda.route_launches[route] = 0
    mlp = mlp_phase(torch, fdn)
    log("fused dense / MLP " + json.dumps(mlp))
    torch.cuda.empty_cache()

    # ---- 11. slice 8: the tuner and head-packed flash -----------------
    slice8, slice8_vs_plain = slice8_phase(torch, fa, ln, ok, rng, smi,
                                           train, bert)

    # ---- 12. slice 14: dropout, remat and bench.py's last two legs -----
    slice14 = slice14_phase(torch, fa, ln, ok, train)

    # ---- 13. slice 16: the watchdog and the overload leg -------------
    slice16_phase(torch, np, build_flagship_engine, phase3_tokens)

    # ---- 14. slice 17: data parallelism and ZeRO-2 on one NCCL rank ------
    slice17 = slice17_phase(torch, fa, ln, ok, xe, wf)
    torch.cuda.empty_cache()

    # ---- 15. slice 18: tensor and sequence parallelism on one NCCL rank ---
    slice18_phase(torch, fa, ln, ok, train)
    torch.cuda.empty_cache()

    # ---- 16. slice 19: pipeline parallelism ------------------------------
    slice19 = slice19_phase(torch, fa, ln, ok)
    torch.cuda.empty_cache()

    # ---- 17. slice 20: context parallelism ------------------------------
    slice20 = slice20_phase(torch, fa, ln, ok, rng, long["leg"]["ms"])
    torch.cuda.empty_cache()

    # ---- 18. slice 21: Mixture-of-Experts ------------------------------
    slice21 = slice21_phase(torch, fa, ln, ok, rng)
    torch.cuda.empty_cache()

    # ---- 19. slice 22: BERT at tp > 1 and the checkpoint package -------
    slice22 = slice22_phase(torch, fa, ln, ok, bert)
    torch.cuda.empty_cache()

    # ---- 20. slice 23: the monitored step ------------------------------
    slice23 = slice23_phase(torch, np, fa, ln, ok, smi)
    torch.cuda.empty_cache()

    # ---- 21. kernel table --------------------------------------------
    q, k, v, tbl, lens = fd_main
    sc = 1.0 / math.sqrt(q.shape[3])
    # a cold cache: read 64 MiB (more than the 50 MB L2) before each
    # launch.  A read leaves the L2 clean; a write would leave the timed
    # kernel paying for the write-back of dirty lines.
    flush_src = torch.ones(64 * 2 ** 20, dtype=torch.int8, device="cuda")
    flush_sink = torch.empty((), dtype=torch.int64, device="cuda")

    def flush():
        torch.sum(flush_src, dim=0, dtype=torch.int64, out=flush_sink)

    fd_t = decode_times(torch, fd, fd_main, flush)
    fd_ms, fd_warm, fd_plain, fd_lib, fd_bound = (
        fd_t[k_] for k_ in ("ms", "warm_l2_ms", "plain_ms", "library_ms",
                            "bound_ms"))
    # how the kernel's time grows with the keys it reads: every slot at
    # length 0 (launch and exit), 1 (one key: the latency chain alone)
    # and 256 (both pages)
    scaling = {}
    for n in (0, 1, 256):
        ln_n = torch.full_like(lens, n)
        scaling[f"len{n}_ms"] = time_ms(torch, lambda: fd.flash_decode_cuda(
            q, k, v, tbl, ln_n, sc), flush=flush)
    log("flash_decode time by slot length (cold L2) " + json.dumps(scaling))
    fd_long_t = decode_times(torch, fd, fd_long, flush)
    log("flash_decode: main shape " + json.dumps(fd_t) + "; long case "
        + json.dumps(fd_long_t))

    # the LayerNorm forward at every main-path shape: decode's 64 rows,
    # GPT-350M's, BERT-Large's and GPT-1.3B's training rows (bf16, weight
    # and bias), each beside F.layer_norm; x, y, w, b once, fp32 mean and
    # rstd written, ~8 flops an element
    ln_by_shape = {}
    for rows_, hid in ((64, 1024), (12288, 1024), (16384, 1024),
                       (3584, 2048)):
        x = torch.randn((rows_, hid), generator=rng, device="cuda").to(bf16)
        w = torch.randn((hid,), generator=rng, device="cuda").to(bf16)
        b = torch.randn((hid,), generator=rng, device="cuda").to(bf16)
        by = 2 * x.numel() * 2 + 2 * hid * 2 + 2 * rows_ * 4
        ln_by_shape[f"({rows_}, {hid})"] = {
            "ms": time_ms(torch, lambda: ln.norm_fwd_cuda(x, w, b, 1e-5,
                                                          False)),
            "library_ms": time_ms(torch, lambda: torch.nn.functional
                                  .layer_norm(x, (hid,), w, b, 1e-5)),
            "bound_ms": 1e3 * max(by / HBM_BYTES_PER_S,
                                  8 * x.numel() / FP32_FLOPS),
            "plan": list(ln.fwd_plan(rows_, hid, 2, ln._sm_count(x.device)))}
        if rows_ in (64, 12288):
            ln_by_shape[f"({rows_}, {hid})"]["plain_ms"] = time_ms(
                torch, lambda: ln.norm_fwd_reference(x, w, b, 1e-5))
        del x
    log("layer_norm fwd by shape: " + json.dumps(ln_by_shape))
    floor = launch_floor_times(torch)
    log("launch floor (time_ms of an empty kernel and of a one-block "
        "16-byte copy, built as the port's kernels): " + json.dumps(floor))
    ln_dec, ln_train = ln_by_shape["(64, 1024)"], ln_by_shape["(12288, 1024)"]

    train_rows = table_train_kernels(torch, fa, ln, ok, rng, errs,
                                     train["launches"],
                                     train["launches_per_step"])
    bert_rows = table_bert_kernels(torch, fa, ok, rng, errs, bert, layout)
    resnet_rows = table_resnet_kernels(torch, xe, wf, ok, rng, errs, resnet,
                                       resnet_spec)
    dense_rows = table_dense_kernels(torch, sm, ok, rng, errs, dense_gpt,
                                     dense_bert, gpt_layout)
    long_rows = table_long_kernels(torch, fa, rng, long)
    slice7_rows = table_slice7_kernels(torch, ok, fdn, rng, errs, adagrad,
                                       mlp, gpt_layout[1], layout)
    slice8_rows = table_slice8_kernels(torch, fa, ok, rng, errs, slice8)
    dropout_rows = table_dropout_kernels(torch, fa, rng, errs, slice14)
    f32_times = f32_kernel_times(torch, fa, rng)
    log("flash backward fp32 outputs vs bf16 (ms) " + json.dumps(f32_times))

    table = {"kernels": [
        {"name": "flash_decode", "route": "cuda",
         "source": "apex_tpu_torch/csrc/flash_decode.cu",
         "replaces": "apex_tpu/ops/flash_decode.py:205",
         "launches": launches["flash_decode"],
         "launches_per_decode_step": c.num_layers,
         "max_abs_err": errs["flash_decode"],
         "ms": fd_ms, "kernel_ms": fd_ms, "warm_l2_ms": fd_warm,
         "plain_ms": fd_plain,
         "bound_ms": fd_bound, "bound_by": "bytes", "library_ms": fd_lib,
         "library": "scaled_dot_product_attention on a pre-gathered cache",
         "shape": "q (64,1,16,64) bf16, pages (16,65,128,64), table (64,2)",
         "plan": fd_t["plan"], "by_slot_length": scaling,
         "long_case": fd_long_t,
         "l2": "flushed (read) before each launch"},
        {"name": "layer_norm_fwd", "route": "cuda",
         "source": "apex_tpu_torch/csrc/layer_norm.cu",
         "replaces": "apex_tpu/ops/layer_norm.py:58",
         "launches": launches["layer_norm"],
         "launches_per_decode_step": n_ln,
         "max_abs_err": errs["layer_norm"],
         "ms": ln_dec["ms"], "kernel_ms": ln_dec["ms"],
         "plain_ms": ln_dec["plain_ms"],
         "launches_train": train["launches"]["layer_norm_fwd"],
         "ms_at_train_shape": ln_train["ms"],
         "library_ms_at_train_shape": ln_train["library_ms"],
         "bound_ms": ln_dec["bound_ms"], "bound_by": "bytes",
         "library_ms": ln_dec["library_ms"],
         "library": "torch.nn.functional.layer_norm",
         "plan": ln_dec["plan"], "by_shape": ln_by_shape,
         "launch_floor": floor,
         "shape": "x (64,1024) bf16, affine", "l2": "warm"},
    ] + train_rows + bert_rows + resnet_rows + dense_rows + long_rows
        + slice7_rows + slice8_rows + dropout_rows}
    add_slice17_columns(table["kernels"], shards, slice17)
    add_slice19_columns(table["kernels"], slice19)
    add_slice20_columns(table["kernels"], slice20, f32_times)
    add_slice21_columns(table["kernels"], slice21)
    add_slice22_columns(table["kernels"], slice22)
    add_slice23_columns(table["kernels"], slice23)
    check(all(r[key] is None and key == "library_ms"
              or math.isfinite(r[key]) for r in table["kernels"]
              for key in ("ms", "plain_ms", "bound_ms", "library_ms")),
          "a timing is not finite")
    log(f"total {time.perf_counter() - t_start:.1f}s")
    log("train step, kernels vs plain " + json.dumps(train_vs_plain))
    log("bert step, kernels vs plain " + json.dumps(bert_vs_plain))
    log("resnet step, kernels vs plain " + json.dumps(resnet_vs_plain))
    log("dense GPT step, kernels vs plain " + json.dumps(dense_gpt_vs_plain))
    log("dense BERT step, kernels vs plain "
        + json.dumps(dense_bert_vs_plain))
    log("long GPT step, kernels vs plain " + json.dumps(long_vs_plain))
    log("adagrad GPT step, kernels vs plain "
        + json.dumps(adagrad_vs_plain))
    log("GPT hp=2 / BERT hp=2 steps, kernels vs plain "
        + json.dumps(slice8_vs_plain))
    log("GPT dropout step, kernels vs plain "
        + json.dumps(slice14["dropout_vs_plain"]))
    log("MoE-GPT step, kernels vs plain " + json.dumps(slice21["vs_plain"]))
    log("BERT tp step, kernels vs plain "
        + json.dumps(slice22["bert_tp"]["vs_plain"]))
    print(json.dumps(table), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
