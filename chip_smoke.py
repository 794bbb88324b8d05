#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (exit code 1, no result line) if it
fails:

  1. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
  2. build: nvcc compiles every kernel source of the checkout, in parallel;
     ptxas must report no register spill in any instance of any of them
     (dsa_decode.cu, dsa_attention.cu, dsa_chunk_prefill.cu, wkv6.cu);
  3. kernels: K1 (decode gather-attend), K2 (block-sparse prefill), K3
     (chunk prefill) and K4 (paged decode) against their plain PyTorch
     versions on the same inputs, at a reduced geometry (hd 16, block 16,
     f32; K2 also bf16) and at yi_6b's full geometry (K1/K4 bf16 q against
     a bf16 and the default f32 cache, and f32; K2 bf16 and f32, and bf16
     at stablelm_3b's width, hd 80 with 32 KV heads, and on its
     sliding-window path at h2o_danube_1_8b's reduced geometry (window 64
     at block 16, f32 and bf16), its f32 parity run's and its prefill's
     (B 4, L 8192, hd 80, G 4, window 4096, 6 blocks kept, bf16, timed);
     K3 every dtype pair;
     K4 also at the continuous slice's shape: 64 logical
     blocks, a 257-page pool, 9 blocks selected), each within a stated
     atol + rtol, with times (CUDA events, L2 flushed before each launch),
     host enqueue time, the plain versions' and one PyTorch library
     call's times, and the least time the card could take; K4 must also
     equal K1 bit for bit on a pool that holds K1's cache under a
     shuffled page table.  The quantized bodies K1q, K4q and K3q on int8
     and fp8 caches at the reduced geometry and at the main path's shapes
     (bf16 q), each also bit for bit equal to its unquantized kernel on
     the dequantized cache; K5 and K5q (the paged chunk kernel, no model
     path) bit for bit equal to K3 and K3q on a shuffled pool; times as
     above, the bound counted from the narrow bytes;
  4. parity: yi_6b at full width with 2 layers in f32 serves the same
     greedy tokens with dsa_mode="kernel" as with the plain "block" path,
     and four requests get the same greedy tokens from the continuous
     engine (paged cache, kernel path), the continuous engine (dense
     cache, block path) and the static engine; the page pool returns full.
     With int8 K/V and int8 selection the two chunked continuous engines
     agree, and the static engine agrees with the paged kernel engine
     under blocking admission (chunked admission attends a chunk's own
     rows quantized, whole-prompt prefill in full precision).  Graphed
     decode against eager decode, bit for bit: the static engine's scan
     loop (a CUDA graph replay a step) against its python loop (eager
     steps), f32 and fp8 K/V, and the paged continuous engine's segments
     (replays of the masked step's graph) against each request's solo
     python-loop generate, greedy and sampled, f32 and int8 K/V (int8
     under blocking admission), with one capture per engine;
  5. the static slice: ``repro_torch.launch.serve`` serves yi_6b at full
     width, all 32 layers in bf16, random weights from --seed, batch 4,
     prompt 4096, 64 new tokens, DSA on the kernel path; the launch
     counters show K2 ran once per layer in prefill and K1 once per layer
     per decode step (each step one replay of the step's CUDA graph, whose
     replays add the launches the capture recorded);
  6. the continuous slice: ``repro_torch.launch.serve --continuous
     --paged`` serves 8 synthetic requests (prompts 1024-4096, 16-64 new
     tokens, all queued at the start) on the same model through 4 slots of
     a paged cache of max_len 8192, chunked admission 512 tokens wide and
     segments of 16 steps; every request must finish ok, K3 must launch
     once per layer per chunk step and K4 once per layer per decode step,
     and the segments must have captured one graph and replayed it once a
     decode step; then a torch.profiler trace of one chunk step and one
     segment;
  7. the quantized slices: phase 5 with an fp8 K/V cache and int8
     selection and 32 new tokens (K1q once per layer per decode step, K1
     never), and phase 6 with int8 K/V and int8 selection (K3q and K4q in
     place of K3 and K4, which must not launch), with the pool's bytes per
     slot and the same profile;
  8. profile: a torch.profiler trace of one prefill and a few decode steps
     of the static slice (wall time, device busy share, top kernels), the
     steps replays of the captured step, with the capture's time and the
     bytes its graph pool reserved;
  9. RWKV6: K7 (chunked wkv6) against its plain version at the reduced
     geometry (B 2, H 4, S 128, hd 16, f32) and at rwkv6_3b's (B 4, H 40,
     S 4096, hd 64, bf16 and f32), each from a zero and a random state,
     y at the dtype's tolerance and s_last at f32's, and in the clamp case
     (w = 0.3: the -30 clamp binds in every chunk) in f32 and bf16, timed
     as above at the main path's case; a 2-layer
     full-width rwkv6_3b in f32 serves the same greedy tokens on the card
     (K7) as on the CPU (the plain version), prompt 512, 16 new, and the
     card's graphed scan loop the same tokens as its eager python loop; the
     rwkv6_3b slice, ``repro_torch.launch.serve --arch rwkv6_3b`` at full
     width, 32 layers in bf16, batch 4, prompt 4096, 64 new tokens: K7
     exactly once per layer in prefill and no attention kernel; a
     torch.profiler trace of its prefill and decode steps; and one timed
     prefill of 4 x 4095 tokens, a length that takes the token scan and
     not K7, at 8 layers (``UNALIGNED_LAYERS``) against an aligned one;
 10. faithful DSA (the paper's token granularity, no kernel): a 2-layer
     full-width yi_6b in f32 serves the same greedy tokens on the card as
     on the CPU, full precision and with fp8 K/V and int8 selection; the
     graphed scan loop equals the eager one and the paged continuous
     engine's segments equal solo eager generates, bit for bit; then the
     full-width slice (32 layers, bf16, batch 4, prompt 4096, 64 new
     tokens) with no kernel launched, and its profile;
 11. sliding window: a 2-layer full-width h2o_danube_1_8b in f32 on
     prompts of 4352 tokens (the 4096-row ring wraps at prefill and in
     decode): DSA off card == CPU, kernel (K2 with the window) == block,
     graphed == eager; then the full-width slice (24 layers, bf16, batch
     4, prompt 8192, 64 new tokens, DSA kernel path): K2 once per layer
     in prefill, no decode kernel, the ring's bytes per batch row, and
     its profile;
 12. training (the paper's joint objective, Eq. 7, with AdamW; the plain
     model path, no kernel): a 2-layer full-width stablelm_3b in f32 with
     remat takes one step (batch 2 x 512, 2 microbatches) on the card and
     on the CPU from the same params: loss, ce, mse and grad_norm agree,
     the new params agree within the first AdamW step's sign bound, P is
     unchanged and no kernel launches; the eval step on the kernel path
     (K2 once a layer) gives the block path's ce; then
     ``repro_torch.launch.train`` trains stablelm_3b at full width (8 of
     its 32 layers, bf16, remat, 4 steps of 4 x 4096 in 2 microbatches): finite
     metrics, P unchanged, no kernel launched, the median step time,
     tokens/s, the 6 N D share of 989 TFLOP/s, peak memory and the bytes
     of params, grads and moments; and a torch.profiler trace of one more
     step and of the optimizer update alone;
 13. prefix reuse and per-request DSA modes in the continuous engine:
     (a) a 2-layer full-width yi_6b in f32 (paged, chunked, 2 slots,
     kernel mode): six requests declaring a 200-token shared prefix get
     the tokens of the same requests undeclared, bit for bit, with hits,
     fewer chunk steps and the pool holding only the registered page
     after, f32 and int8/int8; requests of the four modes on one engine
     (each mode's segments replays of its own graph) get the tokens of
     the same segments eager and, kernel, block and off, of a solo eager
     ``generate(dsa_mode=)``; a block engine's ``generate(dsa_mode=
     "kernel")`` launches K2 once a layer and K1 once a layer a step and
     gives a kernel engine's tokens.  (b) full-width yi_6b (16 of its 32
     layers, bf16, paged, chunk 512, 4 slots, max_len 8192, segments of 16): 8
     requests sharing a 2048-token system prompt (prompts 2304-3648), all
     queued at the start, once declared and once not: equal tokens, K3
     once a layer a chunk step and K4 once a layer a decode step, goodput,
     latency, TTFT, chunk steps and prefix hits, then the pair with int8
     K/V and selection (K3q, K4q); and the continuous slice's workload
     with every other request on dsa_mode "off", with max_mode_wait_s
     None and 0.5: every request ok, each mode's latency, segments and
     switches, and two captured graphs with their pools' bytes;
 14. speculative decoding (K = 4 drafts a round, K1 once a layer per
     verified row): (a) a 2-layer full-width yi_6b in f32 on prompts of
     2048: speculative tokens == the graphed plain tokens in kernel,
     block and off mode and with fp8 K/V and int8 selection (K1q), with
     n-gram, oracle (every draft accepted) and adversarial (every draft
     rejected) proposers and sampled at B 1; a round's verify and commit
     as graph replays == the same calls eager, bit for bit, in every mode,
     faithful included (whose spec tokens are printed, not required); a
     dense continuous engine with spec serves four requests their solo
     tokens, and a paged one reports spec 0.  (b) ``launch.serve --spec
     4`` on the static slice (K2 once a layer, K1 once a layer per verified
     row), then the plain, n-gram, oracle and adversarial runs on one
     engine: rounds, acceptance, tokens a round, delivered tok/s against
     the plain run's, ms a verify replay, a commit replay, an eager commit
     and a drafting call, and the share of positions where the bf16 tokens
     equal the plain run's (printed, not required; where they differ,
     ``scripts/spec_departure.py`` names the first op a verify row departs
     at).  (c) the continuous slice's workload on
     a dense cache, plain and with ``--spec 4``: every request ok,
     goodput, latency, TTFT, acceptance and the K1/K3 launches;
 15. the request lifecycle, fault injection and serving telemetry in the
     continuous engine: (a) a 2-layer full-width yi_6b in f32 (paged,
     kernel path, graphs on, 2 slots) with the fault fixtures of
     tests/test_faults.py scaled up, each gated and each injected fault
     the one that fired: ``nan_logits`` fails only its slot (a prefix of
     its clean tokens, the co-resident request's bit for bit), a
     transient ``dispatch`` leaves the tokens exact, a segment that raises
     fails the in-flight requests and is scrubbed (graphs dropped and
     captured again, the next request exact, the pool full),
     ``pool_exhaust`` waits, an unfundable anchor on an idle engine is
     shed after ``admit_retries``, ``cancel`` of a queued request, a
     chunking member and a resident slot (a co-resident slot bit for
     bit), deadlines in the queue and mid-decode, ``queue_cap`` under each
     shed policy, ``slow_segment`` trips the watchdog, telemetry probing
     every segment gives the plain tokens and a probe leaves every cache
     leaf bitwise, and after ``warmup`` a mixed run captures no graph;
     (b) full-width yi_6b (8 of its 32 layers, bf16), phase 6's workload, three
     plain and three traced runs interleaved on one set of weights:
     goodput, latency, TTFT, K3/K4 launches (K4 once a layer per decode
     and per probe step), the median traced/plain goodput ratio
     (printed), the probe's ms, the trace's events and bytes, the
     Prometheus text's bytes and per-status counts (equal to
     ``summarize()``'s), the sparsity sample (keep rate, churn, layer
     overlap); then, under queue_cap 4 shedding the oldest, a run with
     no deadline that times the four survivors, and a lifecycle run with
     the deadline inside one survivor's decode and another resident
     request cancelled: every non-ok result carries its cause's status,
     at least one request times out mid-decode with partial tokens, the
     pool comes back full, with ``health()`` and the SLO attainment;
     (c) phase 14c's dense
     speculative run with the proposer injected to fail three times: it
     degrades to plain segments and every request is ok;
 16. checkpoints, RWKV6 training, the ``dots`` remat policy and yi_6b
     training: (a) 2-layer full-width rwkv6_3b in f32, one train step
     (the differentiable chunked wkv, no kernel) card against CPU, the
     eval step on the trained model launching K7 once a layer with the
     train form's ce, and 2-layer stablelm_3b's gradients under ``dots``
     against ``full`` with each one's peak memory; (b) 2-layer
     (``CKPT_LAYERS``) full-width stablelm_3b (bf16 params, f32
     moments): a checkpoint
     saved at step 2, restored into a state of another seed bit for bit,
     and the resumed run against the uninterrupted one, at the tolerance
     two uninterrupted runs agree to, with the bytes and the host-copy,
     write and restore seconds; (c) ``repro_torch.launch.train`` trains
     rwkv6_3b at full width (8 of its 32 layers, bf16, 4 x 4096 in 2
     microbatches, 4 steps), no kernel launched, profiled, then its eval
     step launches K7 once a layer; (d) yi_6b at full width (4 of its 32
     layers) with bf16 moments, 4 x 4096 in 2 microbatches (4 if 2 run out of memory),
     4 steps through ``steps.make_train_step``, P unchanged, no kernel,
     profiled.  Each prints its seconds;
 17. mixtral_8x22b, the mixture of experts on a 4096-token ring (K2's
     window instance at hd 128, GQA group 6, held to its plain version in
     phase 3, f32 and bf16, timed at the prefill's shape): (a) 2 layers at
     full width in f32, prompts of 4352: kernel == block greedy tokens
     (K2 twice a prefill), graphed == eager decode, ``moe_prefill=
     "dense"`` runs, the continuous engine (blocking admission) == solo
     generate, and the MoE layer at reduced width card == CPU (f32, 1e-5
     of the largest magnitude, capacity drops included); (b) 8 layers at
     full width in bf16 on a bf16 cache: the static slice through
     ``launch.serve`` (batch 4, prompt 8192, 32 new; K2 once a layer, no
     decode kernel), the share of pairs the capacity prefill dropped,
     profiles of the prefill and of a graphed decode step against the
     expert bytes' bound, one eager step on the default f32 cache, and
     the continuous engine on 8 requests of 4096-8192 tokens; (c) 2
     layers at full width through ``launch.train`` (bf16 moments, 4 x
     4096, 4 steps): the step time, tokens/s, the 6 N D share with N
     active and all, peak memory, the router term and a profiled step;
 18. deepseek_v3, multi-head latent attention after a dense prologue of
     3 layers, then 256 experts (top 8, one shared), which launches none
     of the kernels (the reference's MLA paths are plain: prefill's block
     gather, decode's latent attention): (a) its prologue at full width
     (3 layers, f32), prompts of 1024: graphed == eager, kernel == block
     with no launch, continuous (blocking under block) == solo generate,
     chunked admission under off == whole prefill, speculation (off, K 4)
     == plain, one MLA layer card == CPU (1e-4 of the largest magnitude)
     and reduced deepseek_v3 (MoE included) card == CPU in greedy tokens;
     (b) 5 layers (the prologue and 2 MoE layers) at full width in bf16
     on a bf16 cache through ``launch.serve`` (batch 4, prompt 4096, 32
     new, dsa_mode kernel): no launch, the capacity prefill's drop share,
     profiles of the prefill and of a graphed decode step against the
     time to read its weights once; (c) the continuous engine on that
     model (4 slots, dense cache, max_len 8192, blocking admission, 8
     requests of 1024-4096 tokens); (d) ``launch.train --layers 3`` (the
     prologue alone, 4 x 4096 in 2 microbatches, f32 moments, 4 steps):
     step time, tokens/s, the 6 N D share, peak memory, a profiled step;
 19. jamba_1_5_large (Mamba and attention 7:1, MoE on every other
     sub-block) and recurrent archs in the continuous engine (K2 and K1
     at jamba's geometry, hd 128 with 64 query heads on 8 KV heads, and
     K7 at a continuous admission's batch of 1, held to their plain
     versions in phase 3): (a) one full-width Mamba block in f32 card ==
     CPU (a 1024-token prefill, 16 decode steps; output and state within
     1e-4 of the largest magnitude); reduced jamba (one group of 8) in
     f32 on the card: kernel == block greedy tokens (K2 once a prefill,
     K1 once a step), graphed == eager decode bit for bit (logits and
     every cache leaf, and tokens), continuous (blocking) == solo
     generate, card == CPU tokens; rwkv6_3b at 2 layers, full width,
     f32: continuous == solo generate, K7 once a layer an admission; (b)
     ``launch.serve --arch jamba_1_5_large --layers 5`` ([m, m+MoE, m,
     m+MoE, a], bf16 on a bf16 cache, batch 4, prompt 4096, 32 new,
     dsa_mode kernel; K2 once a prefill, K1 once a step), the capacity
     prefill's drop share, the Mamba scans' share of the prefill, a
     profiled prefill and graphed decode step against the time to read
     the step's weights once, peak memory; (c) the continuous engine on
     that model (4 slots, dense cache, blocking admission, 8 requests of
     1024-4096 tokens); (d) rwkv6_3b at full width (32 layers, bf16) in
     the continuous engine (4 slots, 8 requests of 1024-4096 tokens in
     whole 32-token chunks: K7 once a layer an admission); (e)
     ``launch.train --arch jamba_1_5_large --layers 1`` (one Mamba block
     and a dense MLP, 4 x 4096 in 2 microbatches, f32 moments, 4 steps,
     the chunk-checkpointed scan) with a profiled step, and one reduced
     jamba train step card == CPU;
 20. whisper_small (an encoder-decoder) and llama_3_2_vision (gated
     cross-attention) (K2 and K1 at whisper's MHA geometry, hd 64 and
     GQA group 1, K2 also non-causal, and at llama's, hd 128 and group 4,
     held to their plain versions in phase 3), every cross gate at 0.5:
     (a) whisper at full width with 2 encoder and 2 decoder layers
     (1500 frames, prompts 384) and llama cut to one group of 5 (prompts
     1024, 1601 image tokens), f32: kernel == block greedy tokens (K2
     once a decoder layer a prefill, K1 once a decoder layer a step),
     graphed == eager (tokens, and bit for bit: logits and every cache
     leaf, the cross ``ck``/``cv`` too), continuous (blocking, no cross
     input at admission) == solo generate, card == CPU at batch 1; the
     reduced whisper encoder launches K2 non-causal, == the block path;
     (b) ``launch.serve --arch whisper_small`` (12 + 12 layers, bf16 on
     a bf16 cache, batch 4, prompt 384, 64 new: K2 12 a prefill, K1 12 a
     step), the encoder's ms, profiles of the prefill and a graphed
     decode step; (c) ``launch.serve --arch llama_3_2_vision`` at its
     full 40 layers (batch 4, prompt 4096, 32 new: K2 40, K1 40 a step),
     profiles, the decode step against the time to read its weights
     once, peak memory, then the continuous engine on 8 requests of
     1024-4096 tokens (blocking, bucketed, no images); (d) training with
     the second input: whisper_small whole at 4 x 448, llama at 5
     layers at 4 x 4096 in 2 microbatches, each profiled, and a reduced
     whisper train step card == CPU;
 21. distributed serving (one process a device; K1 and K2 at one tp-2
     shard of yi_6b, 16 query heads on 2 KV heads, held to their plain
     versions in phase 3): (a) two processes on the one card over gloo,
     2-layer full-width yi_6b in f32, kernel DSA: the static engine at tp
     2 and at dp 2, greedy and sampled, and the continuous engine at tp
     2, chunked and then paged with int8 K/V, each with the tokens of
     ``mesh=None`` on the card; each rank's launches and collectives
     (tp: 2 x 2 + 1 all-reduces and one all-gather a step and a
     prefill); (b) yi_6b cut to 8 layers in bf16 at tp 2 (4 x 4096, 32
     new): prefill ms and decode tok/s against the unsharded run, the
     last-row logit gap with DSA off (gated by ``TP_LOGIT_TOL``) and on
     the kernel path (printed), the greedy agreement, each rank's weight
     bytes against the replicated figure and its peak memory; (c) NCCL at
     world size 1 on a ("data", "model") mesh of (1, 1), yi_6b at 8
     layers: the decode graph captures the collectives, graphed == eager
     bit for bit, tokens == ``mesh=None``, the collective counters
     against the budget and the NCCL kernels in a profiler trace.
     Phases 12, 13b, 15b-c and 16c-d run at cut depths since phase 21
     joined the run (8, 16, 16 and 8 layers), the token-scan prefill of
     phase 9 and the checkpoint of 16b since phase 22 did (8 and 2), and
     12, 15b-c and 16d (with 22b and 24a, which read its run) since
     phase 25 did (4, 8 and 4).
 22. sharded training (``training.steps.make_train_step(mesh=, rules=)``,
     the reference's ``make_rules`` tables; no kernel: training takes the
     block path): (a) two gloo processes on the card, yi_6b at full width
     cut to 2 layers in f32 (remat), 3 steps of 4 x 512, on the block
     path and with DSA off: FSDP 2 (``make_rules(tp=False)`` on (2, 1))
     and TP 2 + SP (``make_rules()`` on (1, 2)) against the unsharded run
     on the same rank: with DSA off each step's loss (gated by
     ``SHARD_F32_RTOL``); on the block path FSDP's first loss against the
     unsharded model's on each rank's rows (gated by ``SHARD_ROWS_RTOL``)
     and every gap printed (the 4-bit predictor turns the products' last
     bits into other levels); the collective counters against the budget
     (gated); each rank's bytes of params, grads and moments against the
     unsharded figure; (b) yi_6b at 4 layers in bf16 (bf16 moments, remat,
     4 x 4096 in 2 microbatches: 16d's run) under ``make_rules()`` on
     (2, 1), FSDP over two gloo processes: the median step ms of steps
     2-3, each rank's state bytes against the replicated figure and its
     peak memory, each step's loss gap against 16d's unsharded losses
     beside the predicted tolerance (printed); (c) NCCL at world size 1
     on a (1, 1) mesh under ``make_rules()`` (every collective a group of
     one), yi_6b at 8 layers in bf16, 2 steps of 2 x 512 in 2
     microbatches, deterministic algorithms: the losses and updated
     params against ``mesh=None`` bit for bit (or the first leaf that
     departs and by how much), the counters against the budget (gated),
     the NCCL kernels of one profiled step.
 23. expert-parallel MoE training (``ep_train_phase``): mixtral_8x22b
     at EP 2 x TP 2 + SP as two gloo processes on the card.
 24. the dry run's count against the card (``dryrun_phase``): (a) 16d's
     and 17c's train runs counted as ``launch/dryrun.py`` counts a cell
     (fake tensors, the 1-/2-group form) at world 1 with the H100's
     constants: compute_s gated at or below the measured median step,
     memory_s printed against 16d's profiled busy time; (b) yi_6b's one
     rank at tp 16 (``sharding.shard_config``: 2 query heads on the one
     KV head of their group, G 2) served at 4 x 4096 with 32 new tokens,
     without the collectives: K2 once a layer in prefill, K1 once a
     layer a step, whose checks at that geometry run in phase 3.
 25. tensor parallelism for cross-attention and RWKV6 (``xtp_phase``),
     two gloo processes on the card at tp 2, every cross gate at 0.5:
     (a) whisper_small whole (12 + 12 layers bf16, 4 x 384 and 1500
     frames, 32 new) and its continuous engine on 8 requests, (b)
     llama_3_2_vision at one group of 5 (4 x 4096, 1601 image tokens),
     (c) rwkv6_3b at 4 layers (4 x 4096: K7 on each rank's 20 heads):
     greedy agreement with the unsharded run on rank 0 (printed), the
     last-row logit gap with DSA off (gated by ``TP_LOGIT_TOL``), weight
     bytes a rank, prefill ms, decode tok/s, launches (gated: K2 once a
     decoder layer a prefill and K1 once a step, K7 once a layer a
     prefill) and the collectives against the budget (gated); (d) TP 2 +
     SP training in f32 with DSA off, 2 steps of 2 x 1024 with the second
     input (whisper at 2 + 2 layers, llama at its group of 5, rwkv6_3b at
     2): the losses against the unsharded run on rank 0 (gated by
     ``SHARD_F32_RTOL``) and the counters against the budget (gated).
     Phase 3 checks K1 and K2 at whisper's and llama's tp-2 ranks and K7
     at H 20.
 26. tensor parallelism for Mamba, multi-head latent attention and the
     shared experts (``mtp_phase``), two gloo processes on the card at tp
     2: (a) jamba_1_5_large at 5 sub-blocks (4 x 2048, each rank half of
     Mamba's inner channels and 32 query heads on 4 KV heads) and its
     continuous engine on 6 requests, (b) deepseek_v3's prologue and one
     MoE layer (4 x 2048, 64 MLA heads a rank, the latent cache whole):
     as phase 25's cells (gated: the DSA-off logit gap, deepseek's over
     its dense prologue alone and over the whole model where no router
     call of its MoE layer routed a last row to other experts on the tp
     sums' last bits, which it prints; launches,
     K2 once a prefill and K1 once a step on jamba and none on deepseek,
     and the collectives against the budget); TP 2 + SP training in f32 of
     jamba's first sub-block and deepseek's prologue (bf16 moments; losses and
     counters gated as 25d's); deepseek's first MoE layer with 16 routed
     experts under EP 2 x TP 2 + SP: losses, counters and rank 0's
     gradient of every leaf, the shared experts' among them, against the
     unsharded run (gated by ``SHARD_F32_RTOL``).  Phase 3 checks K1 and
     K2 at jamba's tp-2 rank (G 8 on 4 KV heads).

It then prints one JSON line of per-kernel results, the card's name and
power limit again as ``nvidia-smi`` gives them, and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a card, or outside a checkout of the repository, it exits with 1
and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# (atol, rtol) of a kernel against its plain version on the same inputs:
# |got - want| <= atol + rtol * |want| everywhere.  Both compute in f32; in
# bf16 both round their f32 result once, and one bf16 step is at most 2^-7
# (7.8e-3) of the value, so rtol 1e-2 holds one step; atol covers f32
# summation order on outputs near zero.
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-4, 1e-2)}
# sources whose every instance must build without a register spill
NO_SPILL = ("dsa_decode", "dsa_attention", "dsa_chunk_prefill", "wkv6")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def compare(torch, got, want, dtype: str) -> dict:
    """Max abs error of ``got`` against ``want`` and the largest share of
    the tolerance any element uses (> 1 fails)."""
    atol, rtol = TOL[dtype]
    d = (got.float() - want.float()).abs()
    used = float((d / (atol + rtol * want.float().abs())).max())
    ok = used <= 1.0 and bool(torch.isfinite(got).all())
    return dict(max_abs_err=float(d.max()), tol_used=used,
                tol=[atol, rtol], ok=ok)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Mean device time of a call, with the 50 MB L2 flushed before each
    launch (the main path finds these operands cold).  The queue is held
    behind a spinning kernel while the host enqueues every iteration, so
    the events bracket device work and not the host's launch latency."""

    def __init__(self, torch):
        self.torch = torch
        self.scrub = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, iters: int, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        evs = [(torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        torch.cuda._sleep(int(2e9 * (0.02 + 0.002 * iters)))  # ~cycles
        for s, e in evs:
            self.scrub.zero_()
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in evs) / iters

    def host_us(self, fn, iters: int = 200) -> float:
        """Host time to enqueue one call (no synchronisation inside)."""
        torch = self.torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        return dt / iters * 1e6


def quantize(torch, kc, vc, quant):
    """The narrow cache of a check: (k, v, {k_scale, v_scale}) quantized
    as ``quant`` ("int8" | "fp8"), or the cache itself for None."""
    if quant is None:
        return kc, vc, {}
    from repro_torch.core.quantization import quant_store
    (kq, ks), (vq, vs) = (quant_store(t, dtype=quant) for t in (kc, vc))
    return kq, vq, dict(k_scale=ks, v_scale=vs)


def dequantized(torch, kc, vc, sc):
    """The f32 cache a narrow one stands for (the cache itself if full
    width)."""
    if not sc:
        return kc, vc
    from repro_torch.core.quantization import dequant
    return dequant(kc, sc["k_scale"]), dequant(vc, sc["v_scale"])


def cache_bytes_per_row(kc, sc) -> int:
    """Bytes one (row, KV head) of K or V takes: hd narrow or full-width
    elements plus, narrow, its f32 scale."""
    return kc.shape[-1] * kc.element_size() + (4 if sc else 0)


def equal_unquantized(torch, res, name, got, unq) -> None:
    """Hold a quantized kernel bit for bit to its unquantized kernel on
    the dequantized cache."""
    res["equal_unquantized"] = bool(torch.equal(got, unq))
    if not res["equal_unquantized"]:
        fail(f"{name} is not bitwise equal to its unquantized kernel on the "
             f"dequantized cache: {res}")


def bound(bytes_moved: float, flops: float, dtype: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- K1 -------------------------------------------------------------------------


def check_k1(torch, timer, *, b, hq, hkv, hd, s, bk, q_dt, c_dt, kv_len,
             nb, seed, timed, quant=None):
    """K1 (K1q with ``quant``: the cache drawn in c_dt, then stored
    narrow) against its plain version; K1q also bit for bit against K1
    on the dequantized cache."""
    from repro_torch.core.masks import decode_block_topk_indices
    from repro_torch.kernels import dsa_decode as K1
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def rnd(*shape, d):
        return torch.randn(shape, generator=gen, device=dev).to(dt[d])

    q = rnd(b, hq, 1, hd, d=q_dt)
    kc, vc, sc = quantize(torch, rnd(b, s, hkv, hd, d=c_dt),
                          rnd(b, s, hkv, hd, d=c_dt), quant)
    kvl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    n_kb = -(-s // bk)
    scores = torch.randn((b, n_kb), generator=gen, device=dev)
    idx, ok = decode_block_topk_indices(scores, min(nb, n_kb), kv_len=kvl,
                                        block_k=bk)
    args = (q, kc, vc, idx, ok, kvl)
    kw = dict(block_k=bk, **sc)
    got = K1.dsa_decode_gather_attention(*args, **kw)
    want = K1.dsa_decode_gather_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    kd, vd = dequantized(torch, kc, vc, sc)
    name = "K1q" if quant else "K1"
    res = dict(geometry=f"B{b} Hq{hq} Hkv{hkv} hd{hd} S{s} bk{bk} nb{nb} "
                        f"q {q_dt} cache {quant or c_dt}",
               **compare(torch, got, want, q_dt))
    if not res["ok"]:
        fail(f"{name} disagrees with its plain version: {res}")
    if quant:
        equal_unquantized(torch, res, name, got, K1.dsa_decode_gather_attention(
            q, kd, vd, idx, ok, kvl, block_k=bk))
    if not timed:
        return res
    # bytes this call needs: q, the live selected K/V rows, out, indices
    kpos = idx.long()[:, :, None] * bk + torch.arange(bk, device=dev)
    live = (kpos < kvl[:, None, None]) & ok[:, :, None] & (kpos < s)
    rows = int(live.sum())
    q_el = q.element_size()
    nbytes = (2 * q.numel() * q_el + 2 * rows * hkv * cache_bytes_per_row(
        kc, sc) + 2 * idx.numel() * 4 + kvl.numel() * 4)
    flops = 4.0 * rows * (hq // hkv) * hkv * hd
    work_dt = ("bfloat16" if q_dt == c_dt == "bfloat16" and not quant
               else "float32")
    res["bound_ms"], res["bound_by"] = bound(nbytes, flops, work_dt)
    res["ms"] = timer(lambda: K1.dsa_decode_gather_attention(
        *args, **kw), iters=50)
    res["host_us"] = timer.host_us(lambda: K1.dsa_decode_gather_attention(
        *args, **kw))
    res["plain_ms"] = timer(lambda: K1.dsa_decode_gather_attention_plain(
        *args, **kw), iters=10)
    # library yardstick: one SDPA call over the whole (dequantized) cache
    # with the selected rows as its mask (layouts prepared outside the
    # timing)
    g = hq // hkv
    lib_dt = torch.float32 if work_dt == "float32" else torch.bfloat16
    kk = kd.transpose(1, 2).repeat_interleave(g, 1).to(lib_dt)
    vv = vd.transpose(1, 2).repeat_interleave(g, 1).to(lib_dt)
    qq = q.to(lib_dt)
    rowmask = torch.zeros((b, s), dtype=torch.bool, device=dev)
    bidx = torch.arange(b, device=dev)[:, None, None].expand_as(kpos)
    rowmask[bidx[live], kpos[live]] = True
    mask = rowmask[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_err = float((sdpa(qq, kk, vv, attn_mask=mask).float()
                     - want.float()).abs().max())
    res["library_ms"] = timer(lambda: sdpa(qq, kk, vv, attn_mask=mask),
                              iters=20)
    res["library_max_abs_err"] = lib_err
    return res


# -- K2 -------------------------------------------------------------------------


def check_k2(torch, timer, *, b, hq, hkv, hd, l, blk, nb, dtype, seed,
             timed, window=0, causal=True):
    """K2 against its plain version on the model's selection (with
    ``window``: the sliding-window selection and mask of an SWA arch;
    ``causal=False``: an encoder's selection and mask)."""
    from repro_torch.core.masks import block_topk_indices
    from repro_torch.kernels import dsa_attention as K2
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(td)

    q, k, v = rnd(b, hq, l, hd), rnd(b, hkv, l, hd), rnd(b, hkv, l, hd)
    n = l // blk
    idx, ok = block_topk_indices(
        torch.randn((b, n, n), generator=gen, device=dev), nb,
        causal=causal, window_blocks=window // blk)
    kw = dict(block_q=blk, block_k=blk, causal=causal, window=window)
    got = K2.dsa_block_sparse_attention(q, k, v, idx, ok, **kw)
    want = K2.dsa_block_sparse_attention_plain(q, k, v, idx, ok, **kw)
    torch.cuda.synchronize()
    res = dict(geometry=f"B{b} Hq{hq} Hkv{hkv} hd{hd} L{l} block{blk} "
                        f"nb{nb}{f' window{window}' if window else ''}"
                        f"{'' if causal else ' non-causal'} {dtype}",
               **compare(torch, got, want, dtype))
    if not res["ok"]:
        fail(f"K2 disagrees with its plain version: {res}")
    if not timed:
        return res
    # the work this call's selection needs: the live (query, key) pairs of
    # the valid visited blocks, causal and inside the window; the distinct
    # K/V blocks holding a live pair, read once
    kb = idx.long()
    qpos = torch.arange(l, device=dev).reshape(1, n, 1, blk)
    k_lo = kb[..., None] * blk                            # (B, nQb, nb, 1)
    lo = torch.maximum(k_lo, qpos - window + 1) if window else k_lo
    # (B, nQb, nb, Bq): each query row's last live key of each block
    hi = torch.minimum(k_lo + blk - 1, qpos if causal else qpos + l)
    per = ((hi - lo + 1).clamp(min=0) * ok[..., None]).sum(-1)  # (B,nQb,nb)
    pairs = int(per.sum())
    live = per > 0
    used = torch.zeros((b, n), dtype=torch.bool, device=dev)
    used[torch.arange(b, device=dev)[:, None, None].expand_as(kb)[live],
         kb[live]] = True
    el = q.element_size()
    nbytes = (2 * q.numel() * el + 2 * int(used.sum()) * hkv * blk * hd * el
              + 2 * idx.numel() * 4)
    flops = 4.0 * pairs * hq * hd
    res["bound_ms"], res["bound_by"] = bound(nbytes, flops, dtype)
    res["ms"] = timer(lambda: K2.dsa_block_sparse_attention(
        q, k, v, idx, ok, **kw), iters=5)
    res["host_us"] = timer.host_us(lambda: K2.dsa_block_sparse_attention(
        q, k, v, idx, ok, **kw), iters=20)
    res["plain_ms"] = timer(lambda: K2.dsa_block_sparse_attention_plain(
        q, k, v, idx, ok, **kw), iters=2, warmup=1)
    # library yardstick: one SDPA call with the expanded block mask
    g = hq // hkv
    kk, vv = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    bmask = (torch.nn.functional.one_hot(kb, n).bool()
             & ok[..., None]).any(dim=-2)
    tmask = bmask.repeat_interleave(blk, 1).repeat_interleave(blk, 2)
    if causal:
        tmask &= torch.ones((l, l), dtype=torch.bool, device=dev).tril()
    if window:
        tmask &= ~torch.ones((l, l), dtype=torch.bool,
                             device=dev).tril(-window)
    mask = tmask[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    res["library_max_abs_err"] = float(
        (sdpa(q, kk, vv, attn_mask=mask).float() - want.float()).abs().max())
    res["library_ms"] = timer(lambda: sdpa(q, kk, vv, attn_mask=mask),
                              iters=3, warmup=1)
    del tmask, mask, kk, vv
    return res


# -- K3 -------------------------------------------------------------------------


def check_k3(torch, timer, *, b, hq, hkv, hd, s, c, blk, q_dt, c_dt, q_off,
             chunk_len, seed, timed, quant=None, paged=False):
    """K3 on a chunk of C queries at per-row offsets q_off over an S-row
    cache, rows ragged by chunk_len; the selection is the chunk path's:
    chunk_block_topk_indices of random block scores, keeping yi_6b's
    nb_keep at sparsity 0.9.  ``quant`` stores the cache narrow (K3q,
    held bit for bit to K3 on the dequantized cache); ``paged`` runs K5
    (K5q) on a pool that holds the cache under a shuffled page table,
    held bit for bit to K3 (K3q) on the dense cache."""
    from repro_torch.core.masks import chunk_block_topk_indices, keep_count
    from repro_torch.core.quantization import raw
    from repro_torch.kernels import dsa_chunk_prefill as K3
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def rnd(*shape, d):
        return torch.randn(shape, generator=gen, device=dev).to(dt[d])

    q = rnd(b, hq, c, hd, d=q_dt)
    kc, vc, sc = quantize(torch, rnd(b, s, hkv, hd, d=c_dt),
                          rnd(b, s, hkv, hd, d=c_dt), quant)
    qo = torch.tensor(q_off, dtype=torch.int32, device=dev)
    kvl = qo + torch.tensor(chunk_len, dtype=torch.int32, device=dev)
    n_kb, n_qb = -(-s // blk), c // blk
    nb = min(n_kb, max(2, keep_count(n_kb, 0.9)))
    scores = torch.randn((b, n_qb, n_kb), generator=gen, device=dev)
    idx, ok = chunk_block_topk_indices(scores, nb, q_block_offset=qo // blk)
    dense_args = (q, kc, vc, idx, ok, qo, kvl)
    kw = dict(block_q=blk, block_k=blk, **sc)
    geometry = (f"B{b} Hq{hq} Hkv{hkv} hd{hd} C{c} S{s} block{blk} nb{nb} "
                f"q {q_dt} cache {quant or c_dt}")
    if paged:
        n_pages = b * n_kb + 3
        perm = torch.randperm(
            n_pages - 1, generator=torch.Generator().manual_seed(seed)) + 1
        tbl = perm[:b * n_kb].reshape(b, n_kb).to(dev)
        rows = (tbl[:, :, None] * blk + torch.arange(blk, device=dev)
                ).reshape(b, n_kb * blk)
        pools = []
        for t in (kc, vc, *sc.values()):
            pool = torch.zeros((n_pages * blk,) + tuple(t.shape[2:]),
                               dtype=t.dtype, device=dev)
            raw(pool)[rows] = raw(t)
            pools.append(pool)
        pidx = torch.gather(tbl[:, None, :].expand(b, n_qb, n_kb), 2,
                            idx.long()).to(torch.int32)
        args = (q, pools[0], pools[1], idx, pidx, ok, qo, kvl)
        call_kw = dict(block_q=blk, block_k=blk,
                       **dict(zip(("k_scale", "v_scale"), pools[2:])))
        fn = K3.dsa_chunk_paged_gather_attention
        plain = K3.dsa_chunk_paged_gather_attention_plain
        geometry += f" pages{n_pages}"
    else:
        args, call_kw = dense_args, kw
        fn = K3.dsa_chunk_gather_attention
        plain = K3.dsa_chunk_gather_attention_plain
    got = fn(*args, **call_kw)
    want = plain(*args, **call_kw)
    torch.cuda.synchronize()
    kd, vd = dequantized(torch, kc, vc, sc)
    name = ("K5" if paged else "K3") + ("q" if quant else "")
    res = dict(geometry=geometry, **compare(torch, got, want, q_dt))
    if not res["ok"]:
        fail(f"{name} disagrees with its plain version: {res}")
    if quant:
        equal_unquantized(torch, res, name, got, K3.dsa_chunk_gather_attention(
            q, kd, vd, idx, ok, qo, kvl, block_q=blk, block_k=blk))
    if paged:
        dense = K3.dsa_chunk_gather_attention(*dense_args, **kw)
        res["equal_k3"] = bool(torch.equal(got, dense))
        if not res["equal_k3"]:
            fail(f"{name} is not bitwise equal to K3 on the same rows: {res}")
    if not timed:
        return res
    # the work this call's selection needs: live (query, key) pairs, and
    # the live selected K/V rows read once
    ar = torch.arange(blk, device=dev)
    kpos = idx.long()[..., None] * blk + ar                 # (B,nQb,nb,Bk)
    qpos = (qo.long()[:, None, None]
            + (torch.arange(n_qb, device=dev)[:, None] * blk + ar)[None])
    live_k = (ok[..., None] & (kpos < kvl.long()[:, None, None, None])
              & (kpos < s))
    pair = (live_k[:, :, None]
            & (kpos[:, :, None] <= qpos[:, :, :, None, None]))
    pairs = int(pair.sum())                 # per (row, query, key)
    used = torch.zeros((b, n_kb * blk), dtype=torch.bool, device=dev)
    bidx = torch.arange(b, device=dev)[:, None, None, None].expand_as(kpos)
    used[bidx[live_k], kpos[live_k]] = True
    rows = int(used.sum())
    q_el = q.element_size()
    nbytes = (2 * q.numel() * q_el + 2 * rows * hkv * cache_bytes_per_row(
        kc, sc) + (3 if paged else 2) * idx.numel() * 4 + 2 * b * 4)
    flops = 4.0 * pairs * hq * hd
    work_dt = ("bfloat16" if q_dt == c_dt == "bfloat16" and not quant
               else "float32")
    res["bound_ms"], res["bound_by"] = bound(nbytes, flops, work_dt)
    res["ms"] = timer(lambda: fn(*args, **call_kw), iters=20)
    res["host_us"] = timer.host_us(lambda: fn(*args, **call_kw), iters=50)
    res["plain_ms"] = timer(lambda: plain(*args, **call_kw), iters=3,
                            warmup=1)
    # library yardstick: one SDPA call over the whole (dequantized) cache
    # with the selection, the causal limit and kv_len as a boolean mask
    g = hq // hkv
    lib_dt = dt[work_dt]
    kk = kd.transpose(1, 2).repeat_interleave(g, 1).to(lib_dt)
    vv = vd.transpose(1, 2).repeat_interleave(g, 1).to(lib_dt)
    qq = q.to(lib_dt)
    bm = (torch.nn.functional.one_hot(idx.long(), n_kb).bool()
          & ok[..., None]).any(dim=-2)                     # (B, nQb, nKb)
    tm = bm.repeat_interleave(blk, 1).repeat_interleave(blk, 2)[:, :, :s]
    kj = torch.arange(s, device=dev)
    tm = tm & (kj <= qpos.reshape(b, c)[..., None]) & (kj < kvl[:, None, None])
    mask = tm[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    live_q = tm.any(-1)                     # rows with no live key give NaN
    lib = sdpa(qq, kk, vv, attn_mask=mask).float().transpose(1, 2)
    res["library_max_abs_err"] = float(
        (lib - want.float().transpose(1, 2))[live_q].abs().max())
    res["library_ms"] = timer(lambda: sdpa(qq, kk, vv, attn_mask=mask),
                              iters=5, warmup=1)
    del kk, vv, mask, tm, lib
    return res


# -- K4 -------------------------------------------------------------------------


def check_k4(torch, timer, *, b, hq, hkv, hd, s, bk, q_dt, c_dt, kv_len,
             nb, seed, timed, pages=None, quant=None):
    """K4 on a pool of ``pages`` pages (default: every block of the B
    rows plus the zero page and 2 spare) under a shuffled page table that
    maps each row's blocks up to its kv_len, as the paged cache does, and
    leaves the rest on the zero page; the pool's other rows hold random
    values.  Against its plain version, and bit for bit against K1 on the
    dense cache the table describes.  ``quant`` stores the pool narrow
    (K4q, also held bit for bit to K4 on the dequantized pool)."""
    from repro_torch.core.masks import decode_block_topk_indices
    from repro_torch.core.quantization import take
    from repro_torch.kernels import dsa_decode as K
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def rnd(*shape, d):
        return torch.randn(shape, generator=gen, device=dev).to(dt[d])

    q = rnd(b, hq, 1, hd, d=q_dt)
    kvl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    n_kb = -(-s // bk)
    scores = torch.randn((b, n_kb), generator=gen, device=dev)
    idx, ok = decode_block_topk_indices(scores, min(nb, n_kb), kv_len=kvl,
                                        block_k=bk)
    n_pages = pages or b * n_kb + 3
    used = [-(-n // bk) for n in kv_len]
    perm = torch.randperm(n_pages - 1,
                          generator=torch.Generator().manual_seed(seed)) + 1
    tbl = torch.zeros((b, n_kb), dtype=torch.long)
    taken = 0
    for i, m in enumerate(used):
        tbl[i, :m] = perm[taken:taken + m]
        taken += m
    tbl = tbl.to(dev)
    rows = (tbl[:, :, None] * bk + torch.arange(bk, device=dev)).reshape(
        b, n_kb * bk)[:, :s]
    pk, pv = (rnd(n_pages * bk, hkv, hd, d=c_dt) for _ in range(2))
    pk[:bk] = 0                                        # the zero page
    pv[:bk] = 0
    pk, pv, sc = quantize(torch, pk, pv, quant)
    kc, vc = take(pk, rows), take(pv, rows)            # the dense cache
    dsc = {n: t[rows] for n, t in sc.items()}
    pidx = torch.gather(tbl, 1, idx.long()).to(torch.int32)
    args = (q, pk, pv, idx, pidx, ok, kvl)
    kw = dict(block_k=bk, **sc)
    got = K.dsa_decode_paged_gather_attention(*args, **kw)
    want = K.dsa_decode_paged_gather_attention_plain(*args, **kw)
    k1 = K.dsa_decode_gather_attention(q, kc, vc, idx, ok, kvl, block_k=bk,
                                       **dsc)
    torch.cuda.synchronize()
    kd, vd = dequantized(torch, pk, pv, sc)
    name = "K4q" if quant else "K4"
    res = dict(geometry=f"B{b} Hq{hq} Hkv{hkv} hd{hd} S{s} bk{bk} nb{nb} "
                        f"pages{n_pages} kv_len{list(kv_len)} q {q_dt} "
                        f"cache {quant or c_dt}",
               **compare(torch, got, want, q_dt),
               equal_k1=bool(torch.equal(got, k1)))
    if not res["ok"]:
        fail(f"{name} disagrees with its plain version: {res}")
    if not res["equal_k1"]:
        fail(f"{name} is not bitwise equal to K1{'q' if quant else ''} on "
             f"the same rows: {res}")
    if quant:
        equal_unquantized(torch, res, name, got,
                          K.dsa_decode_paged_gather_attention(
                              q, kd, vd, idx, pidx, ok, kvl, block_k=bk))
    if not timed:
        return res
    # bytes this call needs: q, the live selected K/V rows, out, indices
    kpos = idx.long()[:, :, None] * bk + torch.arange(bk, device=dev)
    live = (kpos < kvl[:, None, None]) & ok[:, :, None]
    nlive = int(live.sum())
    q_el = q.element_size()
    nbytes = (2 * q.numel() * q_el + 2 * nlive * hkv * cache_bytes_per_row(
        pk, sc) + 3 * idx.numel() * 4 + kvl.numel() * 4)
    flops = 4.0 * nlive * hq * hd
    work_dt = ("bfloat16" if q_dt == c_dt == "bfloat16" and not quant
               else "float32")
    res["bound_ms"], res["bound_by"] = bound(nbytes, flops, work_dt)
    res["ms"] = timer(lambda: K.dsa_decode_paged_gather_attention(
        *args, **kw), iters=50)
    res["host_us"] = timer.host_us(
        lambda: K.dsa_decode_paged_gather_attention(*args, **kw))
    res["plain_ms"] = timer(lambda: K.dsa_decode_paged_gather_attention_plain(
        *args, **kw), iters=10)
    # library yardstick: one SDPA call over the whole (dequantized) pool as
    # one sequence, masked to the physical rows of the live selected keys
    g = hq // hkv
    lib_dt = dt[work_dt]
    kk = kd.transpose(0, 1)[None].repeat_interleave(g, 1).to(lib_dt).expand(
        b, -1, -1, -1)
    vv = vd.transpose(0, 1)[None].repeat_interleave(g, 1).to(lib_dt).expand(
        b, -1, -1, -1)
    qq = q.to(lib_dt)
    phys = pidx.long()[:, :, None] * bk + torch.arange(bk, device=dev)
    rowmask = torch.zeros((b, n_pages * bk), dtype=torch.bool, device=dev)
    bidx = torch.arange(b, device=dev)[:, None, None].expand_as(phys)
    rowmask[bidx[live], phys[live]] = True
    mask = rowmask[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    res["library_max_abs_err"] = float(
        (sdpa(qq, kk, vv, attn_mask=mask).float() - want.float()).abs().max())
    res["library_ms"] = timer(lambda: sdpa(qq, kk, vv, attn_mask=mask),
                              iters=20)
    return res


# -- K7 -------------------------------------------------------------------------


def check_k7(torch, timer, *, b, h, s, hd, dtype, seed, timed, w_const=None,
             chunk=32):
    """K7 on (B,H,S,hd) views of model-layout (B,S,H,hd) tensors drawn as
    the reference's kernel tests draw them (w = exp(-exp(0.5 n - 2)), or
    ``w_const``), from a zero state and from a random one, against its
    plain version: y at the dtype's tolerance, s_last at f32's.  Timed on
    the main path's case, a zero state tensor (the prefill cache's)."""
    from repro_torch.kernels import wkv6 as K7
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    r, k, v = rnd(b, s, h, hd), rnd(b, s, h, hd, scale=0.3), rnd(b, s, h, hd)
    w = (torch.full((b, s, h, hd), w_const, device=dev) if w_const
         else torch.exp(-torch.exp(rnd(b, s, h, hd) * 0.5 - 2)))
    r, k, v, w = (t.to(td).transpose(1, 2) for t in (r, k, v, w))
    u = rnd(h, hd, scale=0.1).to(td)
    worst, parts = None, {}
    for name, s0 in (("zero", torch.zeros((b, h, hd, hd), device=dev)),
                     ("random", rnd(b, h, hd, hd, scale=0.5))):
        y, st = K7.wkv6_chunked(r, k, v, w, u, s0, chunk=chunk)
        yp, sp = K7.wkv6_chunked_plain(r, k, v, w, u, s0, chunk=chunk)
        torch.cuda.synchronize()
        for what, c in (("y", compare(torch, y, yp, dtype)),
                        ("s_last", compare(torch, st, sp, "float32"))):
            parts[f"{what} {name} s0"] = c
            if not c["ok"]:
                fail(f"K7 disagrees with its plain version ({what}, {name} "
                     f"s0, B{b} H{h} S{s} hd{hd} {dtype}): {c}")
            if worst is None or c["tol_used"] > worst["tol_used"]:
                worst = c
    res = dict(geometry=f"B{b} H{h} S{s} hd{hd} chunk{chunk} {dtype}"
                        + (f" w={w_const}" if w_const else ""),
               **worst, parts={k: (c["max_abs_err"], c["tol_used"])
                               for k, c in parts.items()})
    if not timed:
        return res
    s0 = torch.zeros((b, h, hd, hd), device=dev)
    el = r.element_size()
    n = b * h * s * hd
    # r, k, v, w read and y written once; u, s0 read and s_last written
    nbytes = 5 * n * el + h * hd * u.element_size() + 2 * b * h * hd * hd * 4
    # per chunk: rr S and k_hat^T v (2 C hd^2 each), the strictly lower
    # triangle of rr kk^T and of its product with v (hd C (C-1) each)
    flops = (b * h * (s // chunk)
             * (4.0 * chunk * hd * hd + 2.0 * hd * chunk * (chunk - 1)))
    res["bound_ms"], res["bound_by"] = bound(nbytes, flops, "float32")
    res["flops"], res["bytes"] = flops, nbytes
    res["ms"] = timer(lambda: K7.wkv6_chunked(r, k, v, w, u, s0,
                                              chunk=chunk), iters=10)
    res["host_us"] = timer.host_us(lambda: K7.wkv6_chunked(
        r, k, v, w, u, s0, chunk=chunk), iters=50)
    res["plain_ms"] = timer(lambda: K7.wkv6_chunked_plain(
        r, k, v, w, u, s0, chunk=chunk), iters=3, warmup=1)
    res["library_ms"] = None          # no single PyTorch call computes wkv6
    return res


# -- engine phases -----------------------------------------------------------


def parity_phase(torch, seed: int) -> dict:
    """yi_6b at full width, 2 layers, f32: kernel mode == block mode, and
    the continuous engine's paths agree with the static engine."""
    from repro_torch.configs.base import get_config
    from repro_torch.inference.engine import Engine
    from repro_torch.models.transformer import init_model
    import numpy as np
    cfg = dataclasses.replace(get_config("yi_6b"), n_layers=2,
                              dtype="float32", param_dtype="float32")
    params = init_model(seed, cfg)
    prompts = np.random.default_rng(seed).integers(
        1, cfg.vocab - 4, size=(2, 512)).astype(np.int32)
    toks = {}
    for mode in ("block", "kernel"):
        eng = Engine(cfg, params, max_len=512 + 16 + 16, long_context=True,
                     dsa_mode=mode)
        toks[mode] = eng.generate(prompts, 16).tokens
    same = bool((toks["block"] == toks["kernel"]).all())
    print(f"parity: 2-layer full-width yi_6b f32, prompt 512, 16 new: "
          f"kernel == block greedy tokens: {same}")
    print(f"  block : {toks['block'][:, :8].tolist()}")
    print(f"  kernel: {toks['kernel'][:, :8].tolist()}")
    if not same:
        fail("kernel mode and block mode disagree on greedy tokens")
    cont = continuous_parity(torch, cfg, params, seed)
    quant = continuous_parity(torch, cfg, params, seed, quant="int8")
    graphs = graph_parity(torch, cfg, params, prompts, seed)
    del params
    torch.cuda.empty_cache()
    return {"same_tokens": same, **cont, "quant": quant, "graphs": graphs}


def graph_parity(torch, cfg, params, prompts, seed: int, n_new: int = 16,
                 max_len: int = 2176) -> dict:
    """Graphed decode == eager decode bit for bit on the kernel path.
    Static: the scan loop (one replay of the step's graph a step, the
    generate run twice on one engine) against the python loop (eager
    steps), f32 and fp8 K/V.  Continuous: a paged engine's segments
    (replays of the masked step's graph) against each request's solo
    python-loop generate, greedy and sampled requests mixed, f32 and int8
    K/V (int8 under blocking admission: chunked admission attends a
    chunk's own rows quantized).  Each engine captures once."""
    import numpy as np
    from repro_torch.inference.engine import Engine
    from repro_torch.inference.scheduler import ContinuousEngine, Request
    out = {}
    for quant in (None, "fp8"):
        kw = dict(max_len=max_len, long_context=True, dsa_mode="kernel",
                  **({} if quant is None else
                     dict(kv_quant=quant, select_dtype="int8")))
        scan = Engine(cfg, params, **kw)
        got = [scan.generate(prompts, n_new).tokens for _ in range(2)]
        want = Engine(cfg, params, loop="python", **kw).generate(
            prompts, n_new).tokens
        same = all(bool((g == want).all()) for g in got)
        label = f"static {quant or 'f32'}"
        print(f"graph parity: {label}, 2-layer full-width yi_6b, prompt "
              f"{prompts.shape[1]}, {n_new} new: scan (graph replays) == "
              f"python (eager) tokens: {same}; {scan.graphs.captures} "
              f"capture, {scan.graphs.replays} replays")
        if not same or scan.graphs.captures != 1:
            fail(f"graph parity, {label}: replayed tokens differ from eager "
                 f"ones or the engine captured {scan.graphs.captures} times")
        out[label] = same
    rng = np.random.default_rng(seed + 3)
    reqs = [Request(i, rng.integers(1, cfg.vocab - 4, size=(n,)).astype(
        np.int32), n_new, greedy=i % 2 == 0, seed=i, temperature=0.8)
        for i, n in enumerate((700, 1100, 512, 900))]
    for quant in (None, "int8"):
        kw = dict(max_len=max_len, long_context=True, dsa_mode="kernel",
                  **({} if quant is None else
                     dict(kv_quant=quant, select_dtype="int8")))
        eng = ContinuousEngine(cfg, params, slots=4, seg_len=16,
                               chunk_tokens=512, paged=True,
                               chunked_prefill=quant is None, **kw)
        got = _run_clean(eng, reqs)
        solo = Engine(cfg, params, loop="python", **kw)
        same = all(bool((got[r.rid] == solo.generate(
            r.prompt[None], n_new, greedy=r.greedy, seed=r.seed,
            temperature=r.temperature).tokens[0]).all()) for r in reqs)
        g = eng.graphs
        label = f"continuous {quant or 'f32'}"
        print(f"graph parity: {label} paged, greedy and sampled: segments "
              f"(graph replays) == solo python generate (eager) tokens: "
              f"{same}; {g.captures} capture, {g.replays} replays for "
              f"{eng.stats['decode_steps']} decode steps")
        if (not same or g.captures != 1
                or g.replays != eng.stats["decode_steps"]):
            fail(f"graph parity, {label}: tokens equal {same}, "
                 f"{g.captures} captures, {g.replays} replays")
        out[label] = same
    return out


def continuous_parity(torch, cfg, params, seed: int, lens=(700, 1100, 512,
                                                          900),
                      n_new: int = 16, max_len: int = 2176,
                      quant=None) -> dict:
    """Four requests of mixed prompt buckets: the continuous engine with
    a paged cache on the kernel path (K3, K4), with a dense cache on the
    plain block path, and the static engine on the kernel path (K2, K1)
    serve the same greedy tokens, and the page pool returns full.

    ``quant`` ("int8"): the same with int8 K/V and int8 selection (K3q,
    K4q, K1q).  Chunked admission then attends each chunk's own rows
    through the quantized cache where whole-prompt prefill attends them in
    full precision (the reference does the same; ROADMAP Queue 3), so the
    chunked engines are held to each other and the static engine to the
    paged kernel engine with blocking admission."""
    import numpy as np
    from repro_torch.inference.engine import Engine
    from repro_torch.inference.scheduler import ContinuousEngine, Request
    rng = np.random.default_rng(seed + 1)
    reqs = [Request(i, rng.integers(1, cfg.vocab - 4, size=(n,)).astype(
        np.int32), n_new, seed=i) for i, n in enumerate(lens)]
    qkw = {} if quant is None else dict(kv_quant=quant, select_dtype="int8")
    kw = dict(slots=4, max_len=max_len, seg_len=16, chunk_tokens=512,
              long_context=True, **qkw)
    got, full = {}, True
    runs = [("paged kernel", dict(paged=True, dsa_mode="kernel")),
            ("dense block", dict(dsa_mode="block"))]
    if quant:
        runs.append(("paged kernel blocking", dict(
            paged=True, dsa_mode="kernel", chunked_prefill=False)))
    for name, extra in runs:
        eng = ContinuousEngine(cfg, params, **kw, **extra)
        got[name] = _run_clean(eng, reqs)
        if eng.paged:
            full &= eng.pool.available() == eng.pool_pages - 1
        del eng
    static = Engine(cfg, params, max_len=max_len, long_context=True,
                    dsa_mode="kernel", **qkw)
    got["static kernel"] = {r.rid: static.generate(r.prompt[None],
                                                   n_new).tokens[0]
                            for r in reqs}

    def agree(a, b):
        return all((got[a][r.rid] == got[b][r.rid]).all() for r in reqs)

    pairs = ([("paged kernel", "dense block"),
              ("paged kernel blocking", "static kernel")] if quant else
             [(k, "static kernel") for k in got if k != "static kernel"])
    same = all(agree(a, b) for a, b in pairs)
    label = f"{quant} K/V and selection" if quant else "f32"
    print(f"parity: continuous engine, 2-layer full-width yi_6b {label}, "
          f"prompts {list(lens)}, {n_new} new: "
          + "; ".join(f"{a} == {b}: {agree(a, b)}" for a, b in pairs)
          + f"; pool back to full: {full}")
    if quant:
        print(f"  (chunked admission == static generate: "
              f"{agree('paged kernel', 'static kernel')}; not required)")
    for k, toks in got.items():
        print(f"  {k:21s}: {[toks[r.rid][:6].tolist() for r in reqs]}")
    if not same:
        fail(f"the continuous and static engines ({label}) disagree on "
             f"greedy tokens")
    if not full:
        fail("the page pool did not get every page back")
    return {"continuous_same_tokens": same, "pool_full": full}


def continuous_phase(torch, seed: int, quant=None) -> dict:
    """The second path: serve yi_6b at full width through the continuous
    engine, chunked admission (K3) and a paged cache (K4).  ``quant``
    ("int8"): the quantized slice, int8 K/V and int8 selection through
    K3q and K4q."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve
    n_layers = get_config("yi_6b").n_layers
    vocab = get_config("yi_6b").vocab
    serve.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30
    results, eng = serve.main([
        "--arch", "yi_6b", "--continuous", "--paged", "--dsa", "--dsa-mode",
        "kernel", "--slots", "4", "--max-len", "8192", "--chunk-tokens",
        "512", "--seg-len", "16", "--requests", "8", "--prompt-len", "4096",
        "--new-tokens", "64", "--rate", "1e9", "--seed", str(seed)]
        + (["--kv-quant", quant, "--select-dtype", "int8"] if quant else []))
    launches = serve.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    slot_bytes = serve.cache_bytes(eng._caches) // eng.slots
    chunk_k, dec_k = ("K3q", "K4q") if quant else ("K3", "K4")
    st = eng.stats
    from repro_torch.inference.scheduler import summarize
    summ = summarize(results, max(r.finish_s for r in results))
    label = f" ({quant} K/V, int8 selection)" if quant else ""
    print(f"continuous slice{label}: {summ['goodput_tok_s']} tok/s "
          f"goodput, latency p50 {summ['p50_latency_s']} s / p95 "
          f"{summ['p95_latency_s']} s, TTFT p50 {summ['p50_ttft_s']} s, "
          f"{st['segments']} segments, {st['admitted']} admissions, "
          f"{st['chunks']} chunk steps, {st['decode_steps']} decode steps, "
          f"peak memory {peak:.2f} GiB ({held:.2f} held at its start), "
          f"pool {slot_bytes} bytes per slot, "
          f"launches " + " ".join(f"{k} {n}" for k, n in launches.items()))
    bad = [r.rid for r in results
           if r.status != "ok" or len(r.tokens) != r.n_new
           or r.tokens.min() < 0 or r.tokens.max() >= vocab]
    if len(results) != 8 or bad:
        fail(f"continuous slice: {len(results)} results, bad {bad}")
    if (st["chunks"] == 0
            or launches[chunk_k] != n_layers * st["chunks"]):
        fail(f"{chunk_k} launched {launches[chunk_k]} times, expected "
             f"{n_layers} x {st['chunks']} chunk steps")
    if (st["decode_steps"] == 0
            or launches[dec_k] != n_layers * st["decode_steps"]):
        fail(f"{dec_k} launched {launches[dec_k]} times, expected "
             f"{n_layers} x {st['decode_steps']} decode steps")
    others = {k: n for k, n in launches.items()
              if k not in (chunk_k, dec_k) and n}
    if others:
        fail(f"the paged, chunked path launched other kernels: {others}")
    if eng.pool.available() != eng.pool_pages - 1:
        fail("the page pool did not get every page back")
    g = eng.graphs
    if g.captures != 1 or g.replays != st["decode_steps"]:
        fail(f"the segments captured {g.captures} graphs and replayed "
             f"{g.replays} times for {st['decode_steps']} decode steps")
    out = {"summary": summ, "peak_gib": peak, "stats": dict(st),
           "slot_bytes": slot_bytes, "launches": launches,
           "capture_ms": [x.capture_ms for x in g.graphs.values()],
           "pool_bytes": g.pool_bytes}
    print(f"  decode graph: capture {out['capture_ms'][0]:.1f} ms, graph "
          f"pool {g.pool_bytes} bytes")
    out["profile"] = continuous_profile(torch, eng, seed, label=label)
    del eng
    return out


def continuous_profile(torch, eng, seed: int, prompt_len: int = 4096,
                       traced_chunks: int = 1, label: str = "") -> dict:
    """Where a chunk step and a segment of the continuous slice spend
    their time: host wall time against the device time of a
    torch.profiler trace, and the top kernels.  One admission group of
    ``slots`` prompts of ``prompt_len`` tokens; its chunk steps run one by
    one."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.inference.scheduler import Request
    eng.reset()
    rng = np.random.default_rng(seed + 2)
    for i in range(eng.slots):
        eng.submit(Request(i, rng.integers(1, eng.cfg.vocab - 4,
                                           size=(prompt_len,)).astype(
                                               np.int32),
                           64, seed=i))
    sink: list = []
    clock = lambda: 0.0
    eng.admit_ready(clock, sink)
    chunk_w = min(eng.chunk_tokens, eng.engine.prompt_bucket(prompt_len))

    def chunk():
        eng.step_prefill(clock, sink, max_chunks=1)

    acts = [ProfilerActivity.CUDA]
    chunk()                                            # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chunk()
    torch.cuda.synchronize()
    chunk_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=acts) as prof:
        for _ in range(traced_chunks):
            chunk()
        torch.cuda.synchronize()
    ch = _device_time(prof, "chunk", traced_chunks)
    eng.step_prefill(clock, sink)      # the rest of the group, then decode
    eng.run_segment(clock, sink)                       # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run_segment(clock, sink)
    seg_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=acts) as prof:
        eng.run_segment(clock, sink)
        torch.cuda.synchronize()
    sg = _device_time(prof, "segment", 1)
    _print_profile(f"chunk step{label} ({eng.slots} x {chunk_w} tokens, "
                   f"bucket {eng.engine.prompt_bucket(prompt_len)})",
                   chunk_ms, *ch)
    _print_profile(f"segment{label} ({eng.seg_len} steps x {eng.slots} "
                   f"slots)", seg_ms, *sg)
    return {"chunk_ms": chunk_ms, "chunk_busy_ms": ch[0],
            "segment_ms": seg_ms, "segment_busy_ms": sg[0]}


def _device_time(prof, name: str, n: int) -> tuple:
    """Device busy ms per run and the kernels by device ms per run, from
    the chrome trace of ``prof`` over ``n`` runs: the union of the kernel,
    memcpy and memset intervals, so overlapping work counts once."""
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        path = Path(tmp) / f"trace_{name}.json"
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())
    events = [e for e in trace["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") in (
                  "kernel", "gpu_memcpy", "gpu_memset")]
    busy, end = 0.0, float("-inf")
    for t0, t1 in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    by_name: dict = {}
    for e in events:
        ms, cnt = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (ms + e["dur"] / 1e3 / n, cnt + 1)
    return busy / 1e3 / n, len(events) / n, by_name


def _print_profile(label: str, wall_ms: float, busy_ms: float,
                   kernels: float, by_name: dict) -> None:
    if not by_name:
        print(f"profile {label}: wall {wall_ms:.2f} ms; the trace holds "
              f"no device events, device time not measured")
        return
    print(f"profile {label}: wall {wall_ms:.2f} ms, device busy "
          f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f} %), "
          f"{kernels:.0f} device kernels")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    for name, (ms, cnt) in top:
        print(f"  {ms:8.3f} ms {cnt:6d}x  {name[:90]}")


def profile_phase(torch, seed: int, steps: int = 8, traced: int = 2,
                  arch: str = "yi_6b", dsa_mode: str = "kernel",
                  prompt_len: int = 4096) -> dict:
    """Where a static slice's time goes: host wall time of one prefill and
    of one decode step against the device time a torch.profiler trace
    sees, and the kernels that take most of it.  ``arch`` at full width,
    bf16, batch 4, ``prompt_len`` tokens; DSA archs on ``dsa_mode``."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import get_config
    from repro_torch.inference.engine import Engine
    from repro_torch.models.transformer import init_model
    cfg = get_config(arch)
    dsa = (dict(long_context=True, dsa_mode=dsa_mode) if cfg.dsa.enabled
           else {})
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(cfg, init_model(seed, cfg), max_len=prompt_len + 64 + 16,
                 **dsa)
    prompts = np.random.default_rng(seed).integers(
        1, cfg.vocab - 4, size=(4, prompt_len)).astype(np.int32)
    acts = [ProfilerActivity.CUDA]

    def run(tok, steps=steps):
        # the scan loop's steps: a replay of the captured step, then the
        # greedy pick on its logits
        for _ in range(steps):
            tok = step(tok)[:, -1].argmax(-1, keepdim=True)
        return tok

    with torch.inference_mode():
        eng.prefill(prompts)                           # warm
        _, _, prefill_s = eng.prefill(prompts)
        with profile(activities=acts) as prof:
            eng.prefill(prompts)
        pre = _device_time(prof, "prefill", 1)
        step = eng.scan_step(4)                        # the capture
        last, _, _ = eng.prefill(prompts, caches=eng.resident_cache(4))
        tok = run(last[:, -1].argmax(-1, keepdim=True))   # warm
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter()
        ev[0].record()
        tok = run(tok)
        ev[1].record()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / steps * 1e3
        event_ms = ev[0].elapsed_time(ev[1]) / steps
        with profile(activities=acts) as prof:
            tok = run(tok, traced)
            torch.cuda.synchronize()
        dec = _device_time(prof, "decode", traced)
    label = arch if dsa_mode == "kernel" or not dsa else f"{arch} {dsa_mode}"
    _print_profile(f"{label} prefill", prefill_s * 1e3, *pre)
    _print_profile(f"{label} decode step (graph replay)", step_ms, *dec)
    print(f"  decode graph: capture {step.capture_ms:.1f} ms, graph pool "
          f"{step.pool_bytes} bytes, {event_ms:.3f} ms a step between CUDA "
          f"events, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    out = {"prefill_ms": prefill_s * 1e3, "prefill_busy_ms": pre[0],
           "step_ms": step_ms, "step_busy_ms": dec[0],
           "step_event_ms": event_ms, "capture_ms": step.capture_ms,
           "pool_bytes": step.pool_bytes}
    del eng
    torch.cuda.empty_cache()
    if cfg.rwkv is not None:
        out["unaligned_prefill_ms"] = unaligned_prefill(torch, seed, cfg,
                                                        prompts)
    return out


# the token-scan prefill's depth: all 32 layers until phase 22 joined the
# run (~33 s of it), 8 since
UNALIGNED_LAYERS = 8


def unaligned_prefill(torch, seed: int, cfg, prompts) -> float:
    """One prefill whose length is no multiple of 32 (4 x 4095) on
    ``cfg`` cut to ``UNALIGNED_LAYERS`` layers: the reference's dispatch
    sends it through the token scan, a Python loop over the tokens of
    every layer, and never through K7; against a 4 x 4096 prefill
    through K7 at the same depth."""
    from repro_torch.configs.base import cut_layers
    from repro_torch.inference.engine import Engine
    from repro_torch.kernels.wkv6 import wkv6_chunked
    from repro_torch.models.transformer import init_model
    cfg = cut_layers(cfg, UNALIGNED_LAYERS)
    eng = Engine(cfg, init_model(seed, cfg), max_len=prompts.shape[1] + 80)
    with torch.inference_mode():
        eng.prefill(prompts)                           # warm
        _, _, aligned = eng.prefill(prompts)
    aligned_ms = aligned * 1e3
    prompts = prompts[:, :-1]
    before = wkv6_chunked.launches
    with torch.inference_mode():
        last, caches, sec = eng.prefill(prompts)
    k7 = wkv6_chunked.launches - before
    finite = bool(torch.isfinite(last).all())
    b, s = prompts.shape
    print(f"{eng.cfg.name} at {cfg.n_layers} layers, unaligned prefill "
          f"({b} x {s}, the token scan): "
          f"{sec * 1e3:.1f} ms ({sec * 1e3 / aligned_ms:.1f} x the {b} x "
          f"{s + 1} prefill through K7, {aligned_ms:.1f} ms; "
          f"{sec * 1e6 / (s * eng.cfg.n_layers):.1f} us a token a layer), "
          f"K7 launches {k7}, logits finite: {finite}", flush=True)
    if k7 or not finite:
        fail(f"unaligned prefill: K7 launched {k7} times, finite {finite}")
    del caches, eng
    torch.cuda.empty_cache()
    return sec * 1e3


def to_cpu(t):
    """A copy of a parameter tree on the CPU (leaves that require grad
    stay leaves that do)."""
    from repro_torch.tree import map_tree
    return map_tree(
        lambda x: x.detach().to("cpu", copy=True).requires_grad_(
            x.requires_grad), t)


def rwkv_parity_phase(torch, seed: int) -> dict:
    """rwkv6_3b at full width, 2 layers, f32: greedy tokens on the card
    (prefill through K7) equal those of the same weights on the CPU (the
    plain version), prompt 512 (chunked), 16 new."""
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.inference.engine import Engine
    from repro_torch.kernels.wkv6 import wkv6_chunked
    from repro_torch.models.transformer import init_model
    cfg = dataclasses.replace(get_config("rwkv6_3b"), n_layers=2,
                              dtype="float32", param_dtype="float32")
    params = init_model(seed, cfg)
    prompts = np.random.default_rng(seed).integers(
        1, cfg.vocab - 4, size=(2, 512)).astype(np.int32)
    before = wkv6_chunked.launches
    scan = Engine(cfg, params, max_len=512 + 16 + 16)
    card = scan.generate(prompts, 16)
    k7 = wkv6_chunked.launches - before
    eager = Engine(cfg, params, max_len=512 + 16 + 16,
                   loop="python").generate(prompts, 16)
    graphed = (bool((card.tokens == eager.tokens).all())
               and scan.graphs.captures == 1
               and card.decode_dispatches == card.decode_steps)
    print(f"graph parity: 2-layer full-width rwkv6_3b f32, prompt 512, 16 "
          f"new: scan (graph replays) == python (eager) tokens: {graphed}; "
          f"{scan.graphs.captures} capture, {scan.graphs.replays} replays")
    if not graphed:
        fail("rwkv6_3b: the graphed scan loop and the eager loop disagree")
    cpu_params = to_cpu(params)
    del params
    torch.cuda.empty_cache()
    cpu = Engine(cfg, cpu_params, max_len=512 + 16 + 16,
                 device="cpu").generate(prompts, 16)
    same = bool((card.tokens == cpu.tokens).all())
    print(f"parity: 2-layer full-width rwkv6_3b f32, prompt 512, 16 new: "
          f"card (K7, {k7} launches) == CPU (plain) greedy tokens: {same}")
    print(f"  card: {card.tokens[:, :8].tolist()}")
    print(f"  cpu : {cpu.tokens[:, :8].tolist()}")
    if not same:
        fail("rwkv6_3b: the card and the CPU disagree on greedy tokens")
    if k7 != cfg.n_layers:
        fail(f"rwkv6_3b parity: K7 launched {k7} times, expected "
             f"{cfg.n_layers}")
    return {"same_tokens": same, "graphed_same_tokens": graphed}


def faithful_parity_phase(torch, seed: int, n_new: int = 16) -> dict:
    """yi_6b at full width, 2 layers, f32, dsa_mode="faithful" (the token
    top-k of prefill and decode, no kernel): greedy tokens on the card
    equal those on the CPU, full precision and with fp8 K/V and int8
    selection, prompt 512; the card's graphed scan loop gives its python
    loop's tokens bit for bit; and the paged continuous engine's graphed
    segments (chunked admission) give the tokens of the same engine's
    eager segments, greedy and sampled.  No kernel launches."""
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.inference.engine import Engine
    from repro_torch.inference.scheduler import ContinuousEngine, Request
    from repro_torch.launch import serve
    from repro_torch.models.transformer import init_model
    cfg = dataclasses.replace(get_config("yi_6b"), n_layers=2,
                              dtype="float32", param_dtype="float32")
    params = init_model(seed, cfg)
    cpu_params = to_cpu(params)
    prompts = np.random.default_rng(seed).integers(
        1, cfg.vocab - 4, size=(2, 512)).astype(np.int32)
    serve.reset_launch_counts()
    out = {}
    for quant in (None, "fp8"):
        kw = dict(max_len=512 + 16 + 16, long_context=True,
                  dsa_mode="faithful",
                  **({} if quant is None else
                     dict(kv_quant=quant, select_dtype="int8")))
        scan = Engine(cfg, params, **kw)
        card = scan.generate(prompts, n_new)
        eager = Engine(cfg, params, loop="python", **kw).generate(prompts,
                                                                  n_new)
        cpu = Engine(cfg, cpu_params, device="cpu", **kw).generate(prompts,
                                                                   n_new)
        graphed = (bool((card.tokens == eager.tokens).all())
                   and scan.graphs.captures == 1)
        same = bool((card.tokens == cpu.tokens).all())
        label = "f32" if quant is None else f"{quant} K/V, int8 selection"
        print(f"parity: 2-layer full-width yi_6b faithful {label}, prompt "
              f"512, {n_new} new: card == CPU greedy tokens: {same}; "
              f"graph parity: scan (graph replays) == python (eager) "
              f"tokens: {graphed}, {scan.graphs.captures} capture")
        print(f"  card: {card.tokens[:, :8].tolist()}")
        print(f"  cpu : {cpu.tokens[:, :8].tolist()}")
        if not (same and graphed):
            fail(f"faithful {label}: card == CPU {same}, graphed == eager "
                 f"{graphed}")
        out[label] = same
    rng = np.random.default_rng(seed + 3)
    reqs = [Request(i, rng.integers(1, cfg.vocab - 4, size=(n,)).astype(
        np.int32), n_new, greedy=i % 2 == 0, seed=i, temperature=0.8)
        for i, n in enumerate((700, 1100, 512, 900))]
    kw = dict(max_len=2176, long_context=True, dsa_mode="faithful")
    got = {}
    for label in ("graphed", "eager"):
        eng = ContinuousEngine(cfg, params, slots=4, seg_len=16,
                               chunk_tokens=512, paged=True, **kw)
        if label == "eager":
            eng.graphs = None            # the same segments, step by step
        got[label] = _run_clean(eng, reqs)
        if label == "graphed":
            g, steps = eng.graphs, eng.stats["decode_steps"]
        del eng
    same = all(bool((got["graphed"][r.rid] == got["eager"][r.rid]).all())
               for r in reqs)
    print(f"graph parity: continuous faithful paged (chunked admission), "
          f"greedy and sampled: segments (graph replays) == the same "
          f"segments eager, tokens: {same}; {g.captures} capture, "
          f"{g.replays} replays for {steps} decode steps")
    if not same or g.captures != 1 or g.replays != steps:
        fail(f"faithful continuous graph parity: tokens equal {same}, "
             f"{g.captures} captures, {g.replays} replays")
    # not required: this engine's products have other shapes than solo
    # generate's (chunks at admission, all slots in decode), the card's
    # GEMMs round by shape, and a token top-k flips on the last bit
    solo = Engine(cfg, params, loop="python", **kw)
    first = {}
    for r in reqs:
        want = solo.generate(r.prompt[None], n_new, greedy=r.greedy,
                             seed=r.seed, temperature=r.temperature).tokens[0]
        diff = np.nonzero(got["graphed"][r.rid] != want)[0]
        first[r.rid] = int(diff[0]) if diff.size else None
    print(f"  (== solo python generate, not required: first differing "
          f"token per request {first})")
    out["continuous"] = same
    n = {k: v for k, v in serve.launch_counts().items() if v}
    if n:
        fail(f"faithful decode and prefill launched kernels: {n}")
    del solo, params
    torch.cuda.empty_cache()
    return out


def h2o_parity_phase(torch, seed: int, n_new: int = 16,
                     prompt_len: int = 4352) -> dict:
    """h2o_danube_1_8b at full width, 2 layers, f32, prompts of 4352
    tokens: past the 4096-token window, so the ring wraps at prefill and
    again in decode.  DSA off: the card's greedy tokens equal the CPU's.
    DSA on the kernel path (K2 with the window, once a layer) equals the
    plain block path on the card, and the graphed scan loop gives the
    python loop's tokens bit for bit."""
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.inference.engine import Engine
    from repro_torch.kernels.dsa_attention import dsa_block_sparse_attention
    from repro_torch.models.transformer import init_model
    cfg = dataclasses.replace(get_config("h2o_danube_1_8b"), n_layers=2,
                              dtype="float32", param_dtype="float32")
    params = init_model(seed, cfg)
    prompts = np.random.default_rng(seed).integers(
        1, cfg.vocab - 4, size=(2, prompt_len)).astype(np.int32)
    max_len = prompt_len + n_new + 16
    toks = {}
    for name, kw in (("off", {}),
                     ("block", dict(long_context=True, dsa_mode="block")),
                     ("kernel", dict(long_context=True, dsa_mode="kernel"))):
        before = dsa_block_sparse_attention.launches
        eng = Engine(cfg, params, max_len=max_len, **kw)
        toks[name] = eng.generate(prompts, n_new).tokens
        k2 = dsa_block_sparse_attention.launches - before
        if k2 != (cfg.n_layers if name == "kernel" else 0):
            fail(f"h2o parity ({name}): K2 launched {k2} times")
        if name == "kernel":
            ring = eng.resident_cache(2)["groups"][0]["b0"]["attn"]["k"]
            eager = Engine(cfg, params, max_len=max_len, loop="python",
                           **kw).generate(prompts, n_new).tokens
            graphed = (bool((toks[name] == eager).all())
                       and eng.graphs.captures == 1)
        del eng
    cpu = Engine(cfg, to_cpu(params), max_len=max_len,
                 device="cpu").generate(prompts, n_new).tokens
    same_cpu = bool((toks["off"] == cpu).all())
    same_k = bool((toks["kernel"] == toks["block"]).all())
    print(f"parity: 2-layer full-width h2o_danube_1_8b f32, prompt "
          f"{prompt_len} (ring of {ring.shape[1]} rows, wrapped at "
          f"prefill and in decode), {n_new} new: DSA off card == CPU "
          f"greedy tokens: {same_cpu}; kernel (K2 with window, "
          f"{cfg.n_layers} launches) == block: {same_k}; graph parity, "
          f"kernel path: scan (graph replays) == python (eager): "
          f"{graphed}")
    for k, t in list(toks.items()) + [("cpu off", cpu)]:
        print(f"  {k:8s}: {t[:, :8].tolist()}")
    if not (same_cpu and same_k and graphed):
        fail("h2o_danube_1_8b parity failed")
    del params
    torch.cuda.empty_cache()
    return {"card_cpu": same_cpu, "kernel_block": same_k,
            "graphed": graphed}


# -- training -----------------------------------------------------------------

# a train step, card against CPU.  Metrics: the predictor's 4-bit fake
# quant rounds an input one ulp apart on the two devices to the next level
# now and then, which moves S~ by a whole step, so mse, the gradients and
# grad_norm differ by ~1e-4 where ce agrees.  New params: the first AdamW
# step moves each element by about lr * sign(g), so a gradient within
# rounding of zero may step the other way (|d| <= 2 lr); nearly all agree
# to 1e-5
TRAIN_METRIC_RTOL = 1e-3
TRAIN_PARAM_SHARE = 0.99


def _p_leaves(params):
    """The frozen DSA projections P of a parameter tree."""
    from repro_torch.optim.adamw import is_frozen
    from repro_torch.tree import named_leaves
    return {k: v for k, v in named_leaves(params) if is_frozen(k)}


def train_parity_phase(torch, seed: int) -> dict:
    """stablelm_3b at full width (d 2560, 32 heads of 80, vocab 50304),
    2 layers, f32, remat on: one train step (``lm_batches``, batch 2 x 512
    tokens, 4 key blocks of which 2 are kept, 2 microbatches) on the card
    and on the CPU from the same params.  loss, ce, mse and grad_norm
    agree at TRAIN_METRIC_RTOL, every new param within 2 lr with at least
    TRAIN_PARAM_SHARE of the elements within 1e-5, P is unchanged bit for
    bit on both, and no kernel launches.  Then the eval step on the kernel
    path (K2 once a layer, no other kernel) gives the block path's ce at
    f32's tolerance."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.synthetic import DataConfig, lm_batches
    from repro_torch.launch import serve
    from repro_torch.models.attention import RunFlags
    from repro_torch.optim import adamw
    from repro_torch.training import steps as ST
    from repro_torch.tree import named_leaves
    cfg = dataclasses.replace(get_config("stablelm_3b"), n_layers=2,
                              dtype="float32", param_dtype="float32")
    opt = adamw.OptConfig(lr=1e-3, total_steps=10, warmup_steps=2)
    batch = next(lm_batches(DataConfig(vocab=cfg.vocab, seq_len=512,
                                       global_batch=2, seed=seed)))
    card, _ = ST.init_train_state(seed, cfg, opt)
    cpu_params = to_cpu(card["params"])
    cpu = {"params": cpu_params, "opt": adamw.init(opt, cpu_params),
           "step": 0}
    p0 = {k: v.cpu() for k, v in _p_leaves(card["params"]).items()}
    step = ST.make_train_step(cfg, opt, microbatches=2)
    serve.reset_launch_counts()
    t0 = time.perf_counter()
    card, m_card = step(card, batch)
    m_card = {k: float(v) for k, v in m_card.items()}
    card_s = time.perf_counter() - t0
    n = {k: v for k, v in serve.launch_counts().items() if v}
    t0 = time.perf_counter()
    cpu, m_cpu = step(cpu, batch)
    cpu_s = time.perf_counter() - t0
    m_cpu = {k: float(v) for k, v in m_cpu.items()}
    rel = {k: abs(m_card[k] - m_cpu[k]) / abs(m_cpu[k])
           for k in ("loss", "ce", "mse", "grad_norm")}
    lr = m_cpu["lr"]
    want = dict(named_leaves(cpu["params"]))
    worst, within, total = 0.0, 0, 0
    for path, p in named_leaves(card["params"]):
        d = (p.detach().cpu() - want[path].detach()).abs()
        worst = max(worst, float(d.max()))
        within += int((d <= 1e-5).sum())
        total += d.numel()
    frozen = all(torch.equal(p0[k], v.cpu()) and torch.equal(
        p0[k], want[k]) for k, v in _p_leaves(card["params"]).items())
    print(f"train parity: 2-layer full-width stablelm_3b f32 (remat), batch "
          f"2 x 512, 2 microbatches: card {card_s:.2f} s, CPU {cpu_s:.2f} "
          f"s; card vs CPU relative differences "
          + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
          + f" (rtol {TRAIN_METRIC_RTOL:g}); new params max |d| {worst:.3g} "
          f"(bound 2 lr = {2 * lr:.3g}), {100 * within / total:.3f} % within "
          f"1e-5; P unchanged: {frozen}; kernels launched: {n or 'none'}",
          flush=True)
    print(f"  card: {', '.join(f'{k} {m_card[k]:.6f}' for k in rel)}")
    print(f"  cpu : {', '.join(f'{k} {m_cpu[k]:.6f}' for k in rel)}")
    if (n or not frozen or worst > 2 * lr
            or within < TRAIN_PARAM_SHARE * total
            or max(rel.values()) > TRAIN_METRIC_RTOL):
        fail("training parity (card vs CPU) failed")
    del cpu, cpu_params
    serve.reset_launch_counts()
    ce = {mode: float(ST.make_eval_step(cfg, RunFlags(
        mode="train", with_mse=False, dsa_mode=mode))(card["params"],
                                                      batch)["ce"])
          for mode in ("block", "kernel")}
    n = {k: v for k, v in serve.launch_counts().items() if v}
    same = abs(ce["kernel"] - ce["block"]) <= 1e-5 * abs(ce["block"])
    print(f"eval on the trained model: ce kernel {ce['kernel']:.7f}, block "
          f"{ce['block']:.7f} (rtol 1e-5: {same}); launches {n}", flush=True)
    if not same or n != {"K2": cfg.n_layers}:
        fail(f"eval on the kernel path: ce {ce}, launches {n}")
    del card
    torch.cuda.empty_cache()
    return {"rel": rel, "params_max_abs": worst, "eval_ce": ce}


def train_slice(torch, seed: int, layers: int = 4) -> dict:
    """Train stablelm_3b at full width through ``repro_torch.launch.train``:
    ``layers`` of its 32 layers (8 since phase 21 joined the run, 4 since
    phase 25 did) in bf16,
    DSA on the block path, remat, 4 steps of batch 4 x
    4096 tokens in 2 microbatches.  Every metric finite, P unchanged, no
    kernel launched.  Prints the median step time over steps 2-4,
    tokens/s, the 6 N D share of the bf16 peak, peak memory and the bytes
    of params, grads and moments; then profiles one more step and the
    optimizer update alone."""
    import math
    import statistics
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import cut_layers, get_config
    from repro_torch.data.synthetic import DataConfig, lm_batches
    from repro_torch.launch import serve, train
    from repro_torch.models.transformer import init_model
    from repro_torch.optim import adamw
    from repro_torch.training import steps as ST
    from repro_torch.tree import named_leaves
    cfg = cut_layers(get_config("stablelm_3b"), layers)
    b, s, steps = 4, 4096, 4
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 2**30
    serve.reset_launch_counts()
    res = train.main(["--arch", "stablelm_3b", "--layers", str(layers),
                      "--steps", str(steps),
                      "--seq", str(s), "--batch", str(b), "--microbatches",
                      "2", "--data", "lm", "--log-interval", "1",
                      "--seed", str(seed)])
    n = {k: v for k, v in serve.launch_counts().items() if v}
    peak = torch.cuda.max_memory_allocated() / 2**30
    state = res.state
    params = state["params"]
    med = statistics.median(res.step_s[1:])
    leaves = list(named_leaves(params))
    n_blocks = sum(p.numel() for k, p in leaves
                   if k.startswith(("/groups/", "/prologue/",
                                    "/enc_groups/")))
    n_head = params["lm_head"].numel()
    flops = 6 * (n_blocks + n_head) * b * s
    share = flops / med / PEAK_FLOPS["bfloat16"]
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    p_bytes = nbytes(p for _, p in leaves)
    g_bytes = nbytes(p for _, p in leaves if p.requires_grad)
    m_bytes = nbytes(t for name in ("m", "v")
                     for _, t in named_leaves(state["opt"][name]))
    finite = all(math.isfinite(v) for m in res.metrics for v in m.values())
    print(f"train slice (stablelm_3b, {layers} layers bf16, DSA block path, "
          f"remat, {steps} steps of {b} x {s} in 2 microbatches): step "
          f"{med * 1e3:.1f} ms (median of steps 2-{steps}; all: "
          + ", ".join(f"{t * 1e3:.1f}" for t in res.step_s)
          + f" ms), {b * s / med:.0f} tok/s; 6 N D / step time / 989 "
          f"TFLOP/s = 6 x {n_blocks + n_head:,} x {b * s} / {med:.4f} s / "
          f"989e12 = {100 * share:.2f} % (N: the {layers} blocks' "
          f"{n_blocks:,} "
          f"params and the lm head's {n_head:,}; the embedding lookup and "
          f"the remat recompute are not counted); peak memory {peak:.2f} "
          f"GiB ({held:.2f} held at its start); params {p_bytes:,} B, "
          f"grads {g_bytes:,} B, moments {m_bytes:,} B; metrics finite: "
          f"{finite}; kernels launched: {n or 'none'}", flush=True)
    if n or not finite:
        fail(f"the train slice launched {n}, metrics finite {finite}")

    # the profile: one more step, then the optimizer update on its own
    opt = adamw.OptConfig(total_steps=steps + 2, warmup_steps=1)
    flags = ST.default_flags(cfg)
    batch = next(lm_batches(DataConfig(vocab=cfg.vocab, seq_len=s,
                                       global_batch=b, seed=seed + 1)))
    step = ST.make_train_step(cfg, opt, flags, microbatches=2)
    acts = [ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        float(m["loss"])
        wall = time.perf_counter() - t0
    tr = _device_time(prof, "train", 1)
    _print_profile(f"stablelm_3b train step ({b} x {s}, 2 microbatches)",
                   wall * 1e3, *tr)
    grads, _ = ST.accumulate_grads(params, cfg, flags, batch, 2)
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    t0 = time.perf_counter()
    ev[0].record()
    adamw.apply_updates(opt, params, grads, state["opt"])
    ev[1].record()
    torch.cuda.synchronize()
    upd_ms = (time.perf_counter() - t0) * 1e3
    grads, _ = ST.accumulate_grads(params, cfg, flags, batch, 2)
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        adamw.apply_updates(opt, params, grads, state["opt"])
        torch.cuda.synchronize()
        upd_traced = time.perf_counter() - t0
    up = _device_time(prof, "update", 1)
    print(f"optimizer update alone: {upd_ms:.1f} ms host clock, "
          f"{ev[0].elapsed_time(ev[1]):.1f} ms between CUDA events, "
          f"{len(leaves)} leaves", flush=True)
    _print_profile("optimizer update (traced)", upd_traced * 1e3, *up)
    del grads
    got = {k: v.clone() for k, v in _p_leaves(params).items()}
    del state, params, res, leaves
    torch.cuda.empty_cache()
    fresh = init_model(seed, cfg)
    frozen = all(torch.equal(v, got[k])
                 for k, v in _p_leaves(fresh).items())
    del fresh, got
    torch.cuda.empty_cache()
    print(f"train slice: P unchanged after {steps + 3} updates: {frozen}",
          flush=True)
    if not frozen:
        fail("the train slice moved P")
    return {"step_ms": med * 1e3, "tok_s": b * s / med, "mfu_6nd": share,
            "peak_gib": peak, "params_bytes": p_bytes, "grads_bytes": g_bytes,
            "moments_bytes": m_bytes, "profile_wall_ms": wall * 1e3,
            "profile_busy_ms": tr[0], "update_ms": upd_ms,
            "update_busy_ms": up[0]}


# -- prefix reuse and per-request modes ---------------------------------------


def _tokens_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        bool((a[k] == b[k]).all()) for k in a)


def prefix_modes_parity_phase(torch, seed: int, card: str) -> dict:
    """13a. yi_6b at full width, 2 layers, f32, paged, chunked (chunk 128,
    the least a 128-row block allows), 2 slots, kernel mode.  Six greedy requests declaring a 200-token shared
    prefix get the tokens of the same requests undeclared, bit for bit,
    with hits and fewer chunk steps, and the pool ends holding only the
    registered page; the same with int8 K/V and int8 selection.  Requests
    of four modes on one kernel-mode engine (every segment a replay of its
    mode's graph) get the tokens of the same engine's eager segments, and
    of a solo eager ``generate(dsa_mode=)`` for kernel, block and off.  A
    block engine's ``generate(dsa_mode="kernel")`` launches K2 once a
    layer and K1 once a layer a step and gives a kernel engine's tokens.
    Every request of a wave has the same n_new, so the waves' groups (and
    the products' shapes) are the same in the runs compared."""
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.inference.engine import Engine
    from repro_torch.inference.scheduler import ContinuousEngine, Request
    from repro_torch.launch import serve
    from repro_torch.models.transformer import init_model
    cfg = dataclasses.replace(get_config("yi_6b"), n_layers=2,
                              dtype="float32", param_dtype="float32")
    params = init_model(seed, cfg)
    rng = np.random.default_rng(seed + 5)
    sys_p = rng.integers(1, cfg.vocab - 4, size=(200,)).astype(np.int32)
    prompts = [np.concatenate([sys_p, rng.integers(
        1, cfg.vocab - 4, size=(t,)).astype(np.int32)])
        for t in (60, 100, 140, 180, 80, 120)]        # 260-380: bucket 512
    kw = dict(max_len=640, slots=2, seg_len=16, chunk_tokens=128,
              paged=True, long_context=True, dsa_mode="kernel")
    out = {}
    for quant in (None, "int8"):
        qkw = {} if quant is None else dict(kv_quant=quant,
                                            select_dtype="int8")
        got, st, pool = {}, {}, {}
        for declare in (True, False):
            eng = ContinuousEngine(cfg, params, **kw, **qkw)
            got[declare] = _run_clean(eng, [
                Request(i, p, 16, seed=i, prefix_len=200 if declare else 0)
                for i, p in enumerate(prompts)])
            st[declare] = dict(eng.stats)
            pool[declare] = (eng.pool.available(), eng.pool_pages,
                             len(eng.pool.prefixes))
            del eng
        n_sh = 200 // 128
        same = _tokens_equal(got[True], got[False])
        label = "f32" if quant is None else f"{quant} K/V, int8 selection"
        print(f"prefix parity: 2-layer full-width yi_6b {label}, 6 requests "
              f"sharing a 200-token prefix ({n_sh} page), chunk 128, 2 "
              f"slots: declared == undeclared tokens: {same}; prefix hits "
              f"{st[True]['prefix_hits']}, tokens reused "
              f"{st[True]['prefix_tokens_reused']}, chunk steps "
              f"{st[True]['chunks']} against {st[False]['chunks']}; pool "
              f"{pool[True][0]} of {pool[True][1]} pages free, "
              f"{pool[True][2]} registration [{card}]", flush=True)
        if not same:
            fail(f"prefix parity ({label}): declared and undeclared tokens "
                 f"differ")
        if (st[True]["prefix_hits"] == 0
                or st[True]["chunks"] >= st[False]["chunks"]
                or pool[True] != (pool[True][1] - 1 - n_sh, pool[True][1], 1)
                or pool[False][0] != pool[False][1] - 1):
            fail(f"prefix parity ({label}): stats {st[True]}, pool "
                 f"{pool}")
        out[f"prefix {label}"] = same
    # per-request modes: two requests a mode, grouped by mode (FIFO)
    modes = [None, "block", "faithful", "off"]
    reqs = [Request(i, rng.integers(1, cfg.vocab - 4, size=(n,)).astype(
        np.int32), 16, seed=i, dsa_mode=modes[i % 4])
        for i, n in enumerate((300, 340, 380, 420, 460, 500, 320, 480))]
    got = {}
    for label in ("graphed", "eager"):
        eng = ContinuousEngine(cfg, params, **kw)
        if label == "eager":
            eng.graphs = None            # the same segments, step by step
        got[label] = _run_clean(eng, reqs)
        if label == "graphed":
            g, steps = eng.graphs, eng.stats["decode_steps"]
            pools = {k[4]: x.pool_bytes for k, x in g.graphs.items()}
        del eng
    graphed = _tokens_equal(got["graphed"], got["eager"])
    solo = Engine(cfg, params, loop="python", max_len=640,
                  long_context=True, dsa_mode="kernel")
    equal = {}
    for r in reqs:
        want = solo.generate(r.prompt[None], 16, seed=r.seed,
                             dsa_mode=r.dsa_mode).tokens[0]
        m = r.dsa_mode or "kernel"
        equal[m] = equal.get(m, True) and bool(
            (got["graphed"][r.rid] == want).all())
    print(f"mode parity: 2-layer full-width yi_6b f32, a kernel engine "
          f"serving kernel, block, faithful and off requests: segments "
          f"(graph replays) == the same segments eager: {graphed}; == solo "
          f"python generate(dsa_mode=) per mode: {equal} (faithful not "
          f"required: a token top-k flips on the last bit of products of "
          f"other shapes); {g.captures} captures, {g.replays} replays for "
          f"{steps} decode steps; graph pool bytes per mode {pools} "
          f"[{card}]", flush=True)
    if (not graphed or not all(equal[m] for m in ("kernel", "block", "off"))
            or g.captures != 4 or g.replays != steps):
        fail(f"mode parity: graphed == eager {graphed}, == solo {equal}, "
             f"{g.captures} captures, {g.replays} replays")
    out["modes"] = equal
    # the static override: a block engine's generate on the kernel path
    prompts = rng.integers(1, cfg.vocab - 4, size=(2, 512)).astype(np.int32)
    block = Engine(cfg, params, max_len=544, long_context=True,
                   dsa_mode="block")
    serve.reset_launch_counts()
    res = block.generate(prompts, 16, dsa_mode="kernel")
    n = {k: v for k, v in serve.launch_counts().items() if v}
    want_n = {"K2": cfg.n_layers, "K1": cfg.n_layers * res.decode_steps}
    kern = Engine(cfg, params, max_len=544, long_context=True,
                  dsa_mode="kernel").generate(prompts, 16).tokens
    same = bool((res.tokens == kern).all())
    print(f"static override: a block engine's generate(dsa_mode=\"kernel\"), "
          f"prompt 512, 16 new: launches {n} (want {want_n}), tokens == a "
          f"kernel engine's: {same} [{card}]", flush=True)
    if n != want_n or not same:
        fail(f"static override: launches {n}, want {want_n}; tokens equal "
             f"{same}")
    out["static override"] = same
    del params, solo, block
    torch.cuda.empty_cache()
    return out


def _run_clean(eng, reqs) -> dict:
    """``eng.run(reqs)``, failing the smoke unless every request finished
    ok.  The engine turns a segment that raised (a refused launch, a
    failed capture, an OOM) into "failed" results and serves on, so a run
    that injects nothing must show no failed, shed, timed-out or cancelled
    request, no dispatch failure and no last error."""
    got = eng.run(reqs)
    h = eng.health()
    bad = {k: h[k] for k in ("failed", "dispatch_failures", "shed",
                             "timeout", "cancelled") if h[k]}
    if bad or h["last_error"] is not None:
        at = sys._getframe(1)
        fail(f"{at.f_code.co_name} (line {at.f_lineno}): the continuous "
             f"engine reported {bad}, last error {h['last_error']!r}")
    return got


def _serve_counted(eng, reqs) -> dict:
    """Serve ``reqs`` (all queued at the start) on a warm engine: the
    summary, the stats' increments, the launches, and per mode the
    segments, decode steps and chunk steps with their host wall seconds
    (a segment ends in its host sync), and the mode switches."""
    from repro_torch.inference.scheduler import summarize
    from repro_torch.launch import serve
    per = {}
    seq = []
    seg, chunk = eng.run_segment, eng._chunk

    def mode(m):
        return per.setdefault(m, {"segments": 0, "decode_steps": 0,
                                  "segment_s": 0.0, "chunks": 0})

    def counted_segment(clock, results):
        m = eng._cur_mode
        d = eng.stats["decode_steps"]
        t0 = time.monotonic()
        seg(clock, results)
        p = mode(m)
        p["segment_s"] += time.monotonic() - t0
        p["segments"] += 1
        p["decode_steps"] += eng.stats["decode_steps"] - d
        if not seq or seq[-1] != m:
            seq.append(m)

    def counted_chunk(pf):
        mode(pf.mode)["chunks"] += 1
        return chunk(pf)

    eng.run_segment, eng._chunk = counted_segment, counted_chunk
    st0 = dict(eng.stats)
    serve.reset_launch_counts()
    try:
        results = eng.serve(reqs)
    finally:
        del eng.run_segment, eng._chunk
    launches = serve.launch_counts()
    st = {k: v - st0[k] for k, v in eng.stats.items()
          if not isinstance(v, list)}          # accept_hist is a list
    summ = summarize(results, max(r.finish_s for r in results))
    bad = [r.rid for r in results
           if r.status != "ok" or len(r.tokens) != r.n_new
           or r.tokens.min() < 0 or r.tokens.max() >= eng.cfg.vocab]
    if len(results) != len(reqs) or bad:
        fail(f"{len(results)} results of {len(reqs)}, bad {bad}")
    return {"results": results, "summary": summ, "stats": st,
            "launches": launches, "per_mode": per,
            "switches": max(0, len(seq) - 1)}


def prefix_modes_slice(torch, seed: int, card: str) -> dict:
    """13b. yi_6b at full width (16 of its 32 layers since phase 21
    joined the run, bf16, random weights from
    ``seed``), paged, chunked (chunk 512), 4 slots, max_len 8192, segments
    of 16, kernel mode, f32 cache.  The prefix run: 8 greedy requests, all
    queued at the start, one 2048-token system prompt (16 pages) and tails
    of 256-1600 tokens (prompts 2304-3648, bucket 4096), 16-64 new tokens
    (the first four 48 each, so they retire together and the last four
    admit as one group in every run), once declaring prefix_len 2048 and
    once not: equal tokens, K3 once a layer a chunk step and K4 once a
    layer a decode step; then the pair with int8 K/V and int8 selection
    (K3q/K4q, and no K3/K4).  The mixed-mode run: the continuous slice's
    workload with every other request on dsa_mode "off", with
    max_mode_wait_s None and 0.5: every request ok, two graphs."""
    import numpy as np
    from repro_torch.configs.base import cut_layers, get_config
    from repro_torch.inference.scheduler import (ContinuousEngine, Request,
                                                 synthetic_workload)
    from repro_torch.models.transformer import init_model
    cfg = cut_layers(get_config("yi_6b"), 16)
    n_layers = cfg.n_layers
    params = init_model(seed, cfg)
    rng = np.random.default_rng(seed + 7)
    sys_p = rng.integers(1, cfg.vocab - 4, size=(2048,)).astype(np.int32)
    tails = rng.integers(256, 1601, size=8)
    n_new = [48] * 4 + [int(x) for x in rng.integers(16, 65, size=4)]
    prompts = [np.concatenate([sys_p, rng.integers(
        1, cfg.vocab - 4, size=(int(t),)).astype(np.int32)]) for t in tails]
    kw = dict(max_len=8192, slots=4, seg_len=16, chunk_tokens=512,
              paged=True, long_context=True, dsa_mode="kernel")
    warm = Request(-1, prompts[0][:512], 2)
    out = {"launches": {}}
    for quant in (None, "int8"):
        qkw = {} if quant is None else dict(kv_quant=quant,
                                            select_dtype="int8")
        eng = ContinuousEngine(cfg, params, **kw, **qkw)
        _run_clean(eng, [warm])          # the capture, outside the timing
        runs = {}
        for declare in (False, True):
            runs[declare] = r = _serve_counted(eng, [
                Request(i, p, n_new[i], seed=i,
                        prefix_len=2048 if declare else 0)
                for i, p in enumerate(prompts)])
            s, st, n = r["summary"], r["stats"], r["launches"]
            label = (f"{'declared' if declare else 'undeclared'}, "
                     + ("f32" if quant is None else
                        f"{quant} K/V, int8 selection"))
            ck, dk = ("K3q", "K4q") if quant else ("K3", "K4")
            print(f"prefix slice ({label}): 8 requests, prompts "
                  f"{min(map(len, prompts))}-{max(map(len, prompts))}: "
                  f"{s['goodput_tok_s']} tok/s goodput, latency p50 "
                  f"{s['p50_latency_s']} s / p95 {s['p95_latency_s']} s, "
                  f"TTFT p50 {s['p50_ttft_s']} s / p95 {s['p95_ttft_s']} s, "
                  f"{st['chunks']} chunk steps, {st['decode_steps']} decode "
                  f"steps, prefix hits {st['prefix_hits']}, tokens reused "
                  f"{st['prefix_tokens_reused']}, launches {ck} {n[ck]} "
                  f"{dk} {n[dk]} [{card}]", flush=True)
            want = {ck: n_layers * st["chunks"],
                    dk: n_layers * st["decode_steps"]}
            if {k: v for k, v in n.items() if v} != want:
                fail(f"prefix slice ({label}): launches {n}, want {want}")
            out["launches"][f"prefix {label}"] = n
        tok = {d: {x.rid: x.tokens for x in runs[d]["results"]}
               for d in runs}
        same = _tokens_equal(tok[True], tok[False])
        hits = runs[True]["stats"]["prefix_hits"]
        fewer = runs[True]["stats"]["chunks"] < runs[False]["stats"]["chunks"]
        print(f"  declared == undeclared tokens: {same}; hits {hits}; fewer "
              f"chunk steps: {fewer}; pool {eng.pool.available()} of "
              f"{eng.pool_pages} pages free, {len(eng.pool.prefixes)} "
              f"registration", flush=True)
        if not (same and hits and fewer):
            fail(f"prefix slice: tokens equal {same}, hits {hits}, fewer "
                 f"chunks {fewer}")
        if eng.pool.available() != eng.pool_pages - 1 - 16:
            fail("prefix slice: the pool holds more than the registration")
        out[quant or "f32"] = {d: {k: runs[d][k] for k in (
            "summary", "stats")} for d in runs}
        del eng
        torch.cuda.empty_cache()
    # the mixed-mode run: the continuous slice's workload, odd rids "off"
    eng = ContinuousEngine(cfg, params, **kw)
    _run_clean(eng, [warm])
    for wait in (None, 0.5):
        eng.max_mode_wait_s = wait
        reqs = synthetic_workload(8, rate_rps=1e9, prompt_lens=(1024, 4096),
                                  n_new_range=(16, 64), vocab=cfg.vocab,
                                  seed=seed)
        for r in reqs:
            r.dsa_mode = "off" if r.rid % 2 else None
        r = _serve_counted(eng, reqs)
        lat = {}
        for m in ("kernel", "off"):
            xs = [x.latency_s for x in r["results"]
                  if (reqs[x.rid].dsa_mode or "kernel") == m]
            lat[m] = (round(float(np.percentile(xs, 50)), 3),
                      round(float(np.percentile(xs, 95)), 3))
        per = r["per_mode"]
        n = r["launches"]
        print(f"mixed-mode slice (max_mode_wait_s {wait}): "
              f"{r['summary']['goodput_tok_s']} tok/s goodput; latency "
              f"p50/p95 kernel {lat['kernel'][0]}/{lat['kernel'][1]} s, off "
              f"{lat['off'][0]}/{lat['off'][1]} s; per mode (segments, "
              f"decode steps, ms a decode step, chunk steps) "
              + ", ".join(f"{m} {p['segments']}/{p['decode_steps']}/"
                          f"{1e3 * p['segment_s'] / max(p['decode_steps'], 1):.2f}/"
                          f"{p['chunks']}" for m, p in per.items())
              + f"; {r['switches']} mode switches; launches K3 {n['K3']} K4 "
              f"{n['K4']} [{card}]", flush=True)
        k = per.get("kernel", {"chunks": 0, "decode_steps": 0})
        want = {"K3": n_layers * k["chunks"],
                "K4": n_layers * k["decode_steps"]}
        if {x: v for x, v in n.items() if v} != {x: v for x, v in
                                                 want.items() if v}:
            fail(f"mixed-mode slice: launches {n}, want {want}")
        out["launches"][f"mixed {wait}"] = n
        out[f"mixed {wait}"] = {"summary": r["summary"], "latency": lat,
                                "per_mode": per, "switches": r["switches"]}
    g = eng.graphs
    pools = {key[4]: x.pool_bytes for key, x in g.graphs.items()}
    print(f"  segment graphs: {g.captures} captured, pool bytes per mode "
          f"{pools} [{card}]", flush=True)
    if g.captures != 2 or len(pools) != 2:
        fail(f"mixed-mode slice: {g.captures} graphs captured, want 2")
    out["graph_pool_bytes"] = pools
    del eng, params
    torch.cuda.empty_cache()
    return out


class _Oracle:
    """A draft proposer that drafts the continuation of known sequences:
    every draft accepted, or, shifted by one token id, every draft
    rejected."""

    def __init__(self, fulls, shift: int, vocab: int):
        import numpy as np
        self.fulls = [np.asarray(f, np.int32) for f in fulls]
        self.shift = shift
        self.vocab = vocab

    def propose(self, contexts, k):
        import numpy as np
        out = np.empty((len(contexts), k), np.int32)
        for r, ctx in enumerate(contexts):
            full = self.fulls[r]
            cont = full[len(ctx):len(ctx) + k]
            row = np.full((k,), full[-1], np.int32)
            row[:cont.size] = cont
            out[r] = (row + self.shift) % self.vocab
        return out


def _verify_bitwise(torch, eng, prompts, k: int) -> bool:
    """One round from the same prefilled state: the verify forward and
    its commit as graph replays (``Engine.spec_steps``, over the resident
    cache) against the same calls eager on a second cache.  True if the
    logits and then every cache leaf after the commit are equal bit for
    bit."""
    from repro_torch.core.quantization import raw
    from repro_torch.models.transformer import (commit_chunk, spec_scratch,
                                                verify_step)
    b, c = prompts.shape[0], k + 1
    flags = dataclasses.replace(eng.decode_flags, spec_verify=True)
    verify, commit = eng.spec_steps(b, k, flags)
    _, graphed, _ = eng.prefill(prompts, caches=eng.resident_cache(b))
    _, eager, _ = eng.prefill(prompts)
    gen = torch.Generator(device="cuda").manual_seed(3)
    chunk = torch.randint(1, eng.cfg.vocab - 4, (b, c), generator=gen,
                          device="cuda")
    mask = torch.ones((b,), dtype=torch.bool, device="cuda")
    keep = torch.arange(b, device="cuda")[:, None] % c + 1
    scratch = spec_scratch(eager, c)
    with torch.inference_mode():
        got = verify(chunk, mask).clone()
        want = verify_step(eng.params, eng.cfg, flags, chunk, eager,
                           active=mask, scratch=scratch)[0]
        commit(keep, mask)
        commit_chunk(eng.cfg, flags, eager, keep[:, 0], c, active=mask,
                     scratch=scratch)
    torch.cuda.synchronize()
    same = torch.equal(got, want)
    for ga, ea in zip(graphed["groups"], eager["groups"]):
        a, e = ga["b0"]["attn"], ea["b0"]["attn"]
        same &= set(a) == set(e) and all(
            torch.equal(raw(a[n]), raw(e[n])) for n in a)
    del eager
    return bool(same)


def spec_parity_phase(torch, seed: int, card: str) -> dict:
    """14a. yi_6b at full width, 2 layers, f32, long_context, K = 4,
    prompts of 2048 (17 blocks of a 2176-row cache, 4 kept).  Static,
    greedy: speculative tokens (n-gram drafts) == the graphed plain
    tokens in kernel, block and off mode and with fp8 K/V and int8
    selection on the kernel path, K1 (K1q) launched n_layers x C a verify
    round; on the kernel path an oracle proposer (every draft accepted)
    and an adversarial one (every draft rejected) give the plain tokens,
    and so does temperature 1 at B 1.  A round's verify and commit as
    graph replays == the same calls eager, bit for bit (logits, then
    every cache leaf), in each mode, faithful included; faithful's spec
    tokens are printed only (a token top-k flips on the last bit between
    products of other shapes).  A dense chunked continuous engine with
    spec on serves four requests their solo tokens; a paged one reports
    spec 0."""
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.inference.engine import Engine
    from repro_torch.inference.scheduler import ContinuousEngine, Request
    from repro_torch.launch import serve
    from repro_torch.models.transformer import init_model
    cfg = dataclasses.replace(get_config("yi_6b"), n_layers=2,
                              dtype="float32", param_dtype="float32")
    params = init_model(seed, cfg)
    k, c, n_new, max_len = 4, 5, 32, 2176
    rng = np.random.default_rng(seed + 7)
    prompts = rng.integers(1, cfg.vocab - 4, size=(2, 2048)).astype(np.int32)
    out = {}
    for mode, quant in (("kernel", None), ("block", None), ("off", None),
                        ("kernel", "fp8"), ("faithful", None)):
        qkw = {} if quant is None else dict(kv_quant=quant,
                                            select_dtype="int8")
        eng = Engine(cfg, params, max_len=max_len, long_context=True,
                     dsa_mode=mode, **qkw)
        plain = eng.generate(prompts, n_new).tokens
        serve.reset_launch_counts()
        res = eng.generate(prompts, n_new, spec=k)
        n = serve.launch_counts()
        kname = "K1q" if quant else "K1"
        want = cfg.n_layers * c * res.spec_rounds if mode == "kernel" else 0
        same = bool((res.tokens == plain).all())
        bitwise = _verify_bitwise(torch, eng, prompts, k)
        label = f"{mode}" + (f", {quant} K/V, int8 selection" if quant
                             else "")
        print(f"spec parity: 2-layer full-width yi_6b f32 {label}, prompt "
              f"2048, {n_new} new, K {k}: spec == plain (graphed scan) "
              f"tokens: {same}; {res.spec_rounds} rounds, accept hist "
              f"{res.spec_accept_hist}; {kname} {n[kname]} (want {want}); "
              f"graphed verify + commit == eager bit for bit: {bitwise} "
              f"[{card}]", flush=True)
        if not bitwise or n[kname] != want or (mode != "faithful"
                                               and not same):
            fail(f"spec parity ({label}): tokens equal {same}, bitwise "
                 f"{bitwise}, {kname} {n[kname]} against {want}")
        out[label] = {"same": same, "bitwise": bitwise,
                      "rounds": res.spec_rounds}
        if mode == "kernel" and quant is None:
            fulls = [np.concatenate([prompts[r], plain[r]]) for r in range(2)]
            for name, shift, rounds in (
                    ("oracle", 0, -(-(n_new - 1) // c)),
                    ("adversarial", 1, n_new - 1)):
                serve.reset_launch_counts()
                r = eng.generate(prompts, n_new, spec=k,
                                 draft=_Oracle(fulls, shift, cfg.vocab))
                n1 = serve.launch_counts()["K1"]
                ok = bool((r.tokens == plain).all())
                print(f"  {name} proposer: tokens == plain: {ok}, "
                      f"{r.spec_rounds} rounds (want {rounds}), accept hist "
                      f"{r.spec_accept_hist}, K1 {n1}", flush=True)
                if not ok or r.spec_rounds != rounds or \
                        n1 != cfg.n_layers * c * rounds:
                    fail(f"spec parity: the {name} proposer")
            one = prompts[:1, :1536]
            want1 = eng.generate(one, 24, greedy=False, seed=11).tokens
            serve.reset_launch_counts()
            r = eng.generate(one, 24, greedy=False, seed=11, spec=k)
            ok = bool((r.tokens == want1).all())
            print(f"  sampled, temperature 1, B 1: spec == plain tokens: "
                  f"{ok}", flush=True)
            if not ok:
                fail("spec parity: sampled spec tokens differ from plain")
        del eng
        torch.cuda.empty_cache()
    reqs = [Request(i, rng.integers(1, cfg.vocab - 4, size=(n,)).astype(
        np.int32), 16, greedy=i % 2 == 0, seed=i)
        for i, n in enumerate((700, 1100, 512, 1900))]
    kw = dict(max_len=max_len, long_context=True, dsa_mode="kernel")
    eng = ContinuousEngine(cfg, params, slots=4, seg_len=16,
                           chunk_tokens=512, spec=k, **kw)
    serve.reset_launch_counts()
    got = _run_clean(eng, reqs)
    n1 = serve.launch_counts()["K1"]
    st = eng.stats
    solo = Engine(cfg, params, **kw)
    same = all(bool((got[r.rid] == solo.generate(
        r.prompt[None], 16, greedy=r.greedy, seed=r.seed).tokens[0]).all())
        for r in reqs)
    paged = ContinuousEngine(cfg, params, slots=4, paged=True, spec=k,
                             **kw).spec
    print(f"spec parity: continuous, dense, chunked, kernel, 4 requests "
          f"(greedy and sampled): == solo generate: {same}; "
          f"{st['spec_rounds']} rounds, accept hist {st['accept_hist']}, "
          f"{st['decode_steps']} plain steps, K1 {n1}; a paged engine's "
          f"spec: {paged} [{card}]", flush=True)
    if (not same or paged != 0 or st["spec_rounds"] == 0 or n1 != cfg.n_layers
            * (st["decode_steps"] + c * st["spec_rounds"])):
        fail("spec parity: the continuous engine")
    out["continuous"] = same
    del params, eng, solo
    torch.cuda.empty_cache()
    return out


def spec_slice(torch, seed: int, card: str) -> dict:
    """14b. The static slice with speculation: yi_6b at full width (32
    layers, bf16), batch 4, prompt 4096, 64 new, kernel path, through
    ``launch.serve --spec 4`` (n-gram drafts): K2 once a layer and K1
    once a layer per verified row; then on one engine of the same weights
    the plain graphed run and the oracle and adversarial proposers.  Per
    run: rounds, accept hist, tokens a round, delivered tok/s; ms a
    verify replay, a commit replay, an eager commit and a drafting call.
    Token agreement with the plain run is printed, not required (bf16
    products over C rows may round otherwise than over one); where it
    fails, the first differing position of each row."""
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.inference.engine import Engine
    from repro_torch.inference.speculative import NGramProposer
    from repro_torch.launch import serve
    from repro_torch.models.transformer import commit_chunk, init_model
    cfg = get_config("yi_6b")
    k, c, b, plen, n_new = 4, 5, 4, 4096, 64
    nl = cfg.n_layers
    serve.reset_launch_counts()
    res = serve.main(["--arch", "yi_6b", "--batch", str(b), "--prompt-len",
                      str(plen), "--new-tokens", str(n_new), "--dsa",
                      "--dsa-mode", "kernel", "--spec", str(k), "--seed",
                      str(seed)])
    n = serve.launch_counts()
    want = {"K2": nl, "K1": nl * c * res.spec_rounds}
    got_n = {x: v for x, v in n.items() if v}
    print(f"spec slice (serve --spec {k}): {res.spec_rounds} rounds, accept "
          f"hist {res.spec_accept_hist}, {res.delivered_tokens} tokens "
          f"delivered in {res.decode_s:.3f} s -> {res.tokens_per_s:.1f} "
          f"tok/s, launches {got_n} (want {want}) [{card}]", flush=True)
    if got_n != want or res.tokens.shape != (b, n_new):
        fail(f"spec slice: launches {got_n}, want {want}")
    spec_launches = dict(n)
    del res
    torch.cuda.empty_cache()
    params = init_model(seed, cfg)
    eng = Engine(cfg, params, max_len=plen + n_new + 16, long_context=True,
                 dsa_mode="kernel")
    prompts = np.random.default_rng(seed).integers(
        1, cfg.vocab - 4, size=(b, plen)).astype(np.int32)
    plain = eng.generate(prompts, n_new)
    plain_tok_s = plain.delivered_tokens / plain.decode_s
    print(f"  plain (graphed scan): {plain.delivered_tokens} tokens in "
          f"{plain.decode_s:.3f} s -> {plain_tok_s:.1f} delivered tok/s "
          f"({plain.tokens_per_s:.1f} tok/s over {plain.decode_steps} "
          f"steps)", flush=True)
    fulls = [np.concatenate([prompts[r], plain.tokens[r]]) for r in range(b)]
    runs = {}
    # the n-gram run twice, first and last: the spread between them
    for name, draft in (("ngram", NGramProposer()),
                        ("oracle", _Oracle(fulls, 0, cfg.vocab)),
                        ("adversarial", _Oracle(fulls, 1, cfg.vocab)),
                        ("ngram again", NGramProposer())):
        serve.reset_launch_counts()
        r = eng.generate(prompts, n_new, spec=k, draft=draft)
        n1, n2 = serve.launch_counts()["K1"], serve.launch_counts()["K2"]
        same = bool((r.tokens == plain.tokens).all())
        agree = float((r.tokens == plain.tokens).mean())
        hist = r.spec_accept_hist
        runs[name] = {"rounds": r.spec_rounds, "hist": hist,
                      "tok_per_round": r.delivered_tokens / r.spec_rounds,
                      "emit_per_row_round": sum(
                          (e + 1) * x for e, x in enumerate(hist)) / sum(hist),
                      "tok_s": r.delivered_tokens / r.decode_s,
                      "decode_s": r.decode_s, "same": same, "agree": agree,
                      "first_diff": [
                          int(np.argmax(x != y)) if (x != y).any() else None
                          for x, y in zip(r.tokens, plain.tokens)],
                      "K1": n1}
        print(f"  {name}: {r.spec_rounds} rounds, accept hist "
              f"{r.spec_accept_hist}, {runs[name]['tok_per_round']:.2f} "
              f"tokens a round ({runs[name]['emit_per_row_round']:.2f} a "
              f"row), {runs[name]['tok_s']:.1f} delivered tok/s "
              f"against plain {plain_tok_s:.1f}; tokens == plain: {same} "
              f"({100 * agree:.1f} % of positions), K2 {n2}, K1 {n1} (want "
              f"{nl}, {nl * c * r.spec_rounds})", flush=True)
        if n1 != nl * c * r.spec_rounds or n2 != nl:
            fail(f"spec slice ({name}): K1 {n1}, K2 {n2}")
    # per-call times at the resident cache after the runs: a verify of C
    # rows on every row, then a commit of none (the pair leaves the cache
    # as it was), as graph replays and the commit also eager
    flags = dataclasses.replace(eng.decode_flags, spec_verify=True)
    verify, commit = eng.spec_steps(b, k, flags)
    caches = eng.resident_cache(b)
    chunk = torch.ones((b, c), dtype=torch.long, device="cuda")
    mask = torch.ones((b,), dtype=torch.bool, device="cuda")
    none = torch.zeros((b, 1), dtype=torch.long, device="cuda")
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(5)]
          for _ in range(12)]
    with torch.inference_mode():
        for e in ev:
            e[0].record()
            verify(chunk, mask)
            e[1].record()
            commit(none, mask)
            e[2].record()
            verify(chunk, mask)
            e[3].record()
            commit_chunk(cfg, flags, caches, none[:, 0], c, active=mask)
            e[4].record()
    torch.cuda.synchronize()
    times = {name: float(np.median([e[i].elapsed_time(e[i + 1])
                                    for e in ev[2:]]))
             for name, i in (("verify_ms", 0), ("commit_ms", 1),
                             ("commit_eager_ms", 3))}
    ctxs = [f[:plen + n_new // 2] for f in fulls]
    dt = []
    for _ in range(10):
        t0 = time.perf_counter()
        NGramProposer().propose(ctxs, k)
        dt.append((time.perf_counter() - t0) * 1e3)
    times["draft_ms"] = float(np.median(dt))
    pools = {key[-2]: g.pool_bytes for key, g in eng.graphs.graphs.items()
             if key[-2] in ("verify", "commit")}
    print(f"  per call: verify replay {times['verify_ms']:.3f} ms, commit "
          f"replay {times['commit_ms']:.3f} ms, commit eager "
          f"{times['commit_eager_ms']:.3f} ms, n-gram drafting "
          f"{times['draft_ms']:.3f} ms (4 rows of ~{plen + n_new // 2} "
          f"tokens); graph pool bytes {pools} [{card}]", flush=True)
    if not all(x["same"] for x in runs.values()):
        print(f"  first position where the spec tokens differ from plain, "
              f"per row: {runs['ngram again']['first_diff']} (where a "
              f"verify row departs: scripts/spec_departure.py)", flush=True)
    del eng, params
    torch.cuda.empty_cache()
    return {"runs": runs, "plain_tok_s": plain_tok_s, "times": times,
            "pools": pools, "launches": spec_launches}


def spec_continuous(torch, seed: int, card: str) -> dict:
    """14c. The continuous slice's workload (8 requests, prompts
    1152-3670, 16-64 new, all queued at the start; 4 slots, max_len 8192,
    chunk 512, segments of 16) on a DENSE resident cache (speculation is
    off on a paged one), kernel path, once plain and once with ``--spec
    4`` (n-gram drafts): every request ok; goodput, latency and TTFT,
    rounds, accept hist, proposer failures; K3 once a layer a chunk step
    and K1 once a layer a plain step and per verified row."""
    from repro_torch.configs.base import get_config
    from repro_torch.inference.scheduler import summarize
    from repro_torch.launch import serve
    nl = get_config("yi_6b").n_layers
    out = {}
    for spec in (0, 4):
        serve.reset_launch_counts()
        results, eng = serve.main([
            "--arch", "yi_6b", "--continuous", "--dsa", "--dsa-mode",
            "kernel", "--slots", "4", "--max-len", "8192", "--chunk-tokens",
            "512", "--seg-len", "16", "--requests", "8", "--prompt-len",
            "4096", "--new-tokens", "64", "--rate", "1e9", "--seed",
            str(seed), "--spec", str(spec)])
        n = serve.launch_counts()
        st = dict(eng.stats)
        summ = summarize(results, max(r.finish_s for r in results))
        bad = [r.rid for r in results if r.status != "ok"
               or len(r.tokens) != r.n_new]
        label = f"spec {spec}" if spec else "plain"
        print(f"spec continuous ({label}, dense): goodput "
              f"{summ['goodput_tok_s']} tok/s, latency p50 "
              f"{summ['p50_latency_s']} / p95 {summ['p95_latency_s']} s, "
              f"TTFT p50 {summ['p50_ttft_s']} / p95 {summ['p95_ttft_s']} s, "
              f"{st['spec_rounds']} rounds, accept hist {st['accept_hist']}, "
              f"proposer failures {st['proposer_failures']}, "
              f"{st['decode_steps']} plain steps, {st['chunks']} chunk "
              f"steps, K1 {n['K1']}, K3 {n['K3']} [{card}]", flush=True)
        want = {"K1": nl * (st["decode_steps"] + 5 * st["spec_rounds"]),
                "K3": nl * st["chunks"]}
        got = {x: v for x, v in n.items() if v}
        if (len(results) != 8 or bad or eng.spec != spec or got != want
                or (spec and st["spec_rounds"] == 0)):
            fail(f"spec continuous ({label}): bad {bad}, spec {eng.spec}, "
                 f"launches {got}, want {want}")
        out[label] = {"summary": summ, "stats": st, "launches": n}
        del eng, results
        torch.cuda.empty_cache()
    return out


# -- phase 15: request lifecycle, faults and telemetry -----------------------


def _drive(eng, reqs, clock=lambda: 0.0) -> list:
    """Queue ``reqs`` and serve them to empty with ``clock``; every result,
    those made outside the loop (sheds, cancels) included."""
    results = []
    for r in reqs:
        eng.submit(r)
    while eng.has_work():
        eng.admit_ready(clock, results)
        eng.step_prefill(clock, results)
        if any(s is not None for s in eng._slot):
            eng._step_decode(clock, results)
    results.extend(eng._pending)
    eng._pending.clear()
    return results


def _by_rid(results) -> dict:
    return {r.rid: r for r in results}


def _clean_health(eng, label: str, failed: int = 0, dispatch: int = 0,
                  error: str = None) -> None:
    """Fail unless the engine saw exactly the failures the phase injected
    (``error``: a text its last error must hold; None: no error)."""
    h = eng.health()
    last = h["last_error"]
    if (h["failed"] != failed or h["dispatch_failures"] != dispatch
            or (error is None and last is not None)
            or (error is not None and (last is None or error not in last))):
        fail(f"lifecycle ({label}): failed {h['failed']} (want {failed}), "
             f"dispatch failures {h['dispatch_failures']} (want "
             f"{dispatch}), last error {last!r}")


def lifecycle_parity_phase(torch, seed: int, card: str) -> dict:
    """15a. yi_6b at full width, 2 layers, f32, paged, kernel path (K3,
    K4), graphs on, 2 slots, max_len 2048, chunks of 256, segments of 8:
    the fault fixtures of tests/test_faults.py scaled up.  Each check
    below is gated, each injected fault must be exactly the one that
    fired, and no failure may show that the check did not inject."""
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.inference.faults import Fault, FaultInjector
    from repro_torch.inference.scheduler import ContinuousEngine, Request
    from repro_torch.inference.telemetry import Telemetry
    from repro_torch.launch import serve
    from repro_torch.models.transformer import init_model
    cfg = dataclasses.replace(get_config("yi_6b"), n_layers=2,
                              dtype="float32", param_dtype="float32")
    params = init_model(seed, cfg)
    kw = dict(slots=2, max_len=2048, seg_len=8, chunk_tokens=256,
              paged=True, long_context=True, dsa_mode="kernel")
    eng = ContinuousEngine(cfg, params, **kw)
    t0 = time.monotonic()

    def mk(shapes, **extra):
        rng = np.random.default_rng(seed + 15)
        return [Request(i, rng.integers(1, cfg.vocab - 4, size=(n,)).astype(
            np.int32), m, seed=7 * i + 1, **extra)
            for i, (n, m) in enumerate(shapes)]

    def prefix(got, want, label):
        if not (0 < len(got) < len(want)
                and bool((got == want[:len(got)]).all())):
            fail(f"lifecycle ({label}): {len(got)} tokens, not a strict "
                 f"prefix of the clean run's {len(want)}")

    def exact(got, want, label):
        if len(got) != len(want) or not bool((got == want).all()):
            fail(f"lifecycle ({label}): tokens differ from the clean run")

    def statuses(res):
        return {r.rid: r.status for r in res}

    shapes = [(600, 40), (650, 48), (300, 24)]   # rid 0 + 1 co-resident
    base = _by_rid(_drive(eng, mk(shapes)))
    if {r.status for r in base.values()} != {"ok"}:
        fail(f"lifecycle (clean run): {statuses(base.values())}")
    _clean_health(eng, "clean run")
    B = {rid: r.tokens for rid, r in base.items()}
    out = {}

    # 1. nan_logits on one resident request
    eng.reset()
    inj = eng.injector = FaultInjector(Fault("nan_logits", rid=1, after=1))
    got = _by_rid(_drive(eng, mk(shapes)))
    eng.injector = None
    if inj.fired != [("nan_logits", 1)] or statuses(got.values()) != {
            0: "ok", 1: "failed", 2: "ok"}:
        fail(f"lifecycle (nan_logits): fired {inj.fired}, statuses "
             f"{statuses(got.values())}")
    prefix(got[1].tokens, B[1], "nan_logits, the poisoned request")
    for rid in (0, 2):
        exact(got[rid].tokens, B[rid], f"nan_logits, rid {rid}")
    _clean_health(eng, "nan_logits", failed=1, error="non-finite")
    out["nan_tokens"] = len(got[1].tokens)

    # 2. a transient dispatch failure
    eng.reset()
    inj = eng.injector = FaultInjector(Fault("dispatch", count=2))
    got = _by_rid(_drive(eng, mk(shapes)))
    eng.injector = None
    if inj.fired != [("dispatch", None)] * 2:
        fail(f"lifecycle (dispatch): fired {inj.fired}")
    for rid in B:
        exact(got[rid].tokens, B[rid], f"dispatch, rid {rid}")
    _clean_health(eng, "dispatch", dispatch=2)

    # 3. a segment that raises once: scrub, recapture, serve on
    eng.reset()
    caps = eng.graphs.captures
    orig, state = eng._segment_step, {"raised": False}

    def boom(mode=None):
        step = orig(mode)                 # the graph exists, then it fails
        if not state["raised"]:
            state["raised"] = True
            raise RuntimeError("injected segment failure")
        return step

    eng._segment_step = boom
    try:
        got = _by_rid(_drive(eng, mk(shapes)))
    finally:
        del eng._segment_step
    if statuses(got.values()) != {0: "failed", 1: "failed", 2: "ok"}:
        fail(f"lifecycle (segment raise): {statuses(got.values())}")
    for rid in (0, 1):
        if len(got[rid].tokens) != 1 or got[rid].tokens[0] != B[rid][0]:
            fail(f"lifecycle (segment raise): rid {rid} kept "
                 f"{got[rid].tokens.tolist()}, not its first token")
    exact(got[2].tokens, B[2], "segment raise, the next request")
    if eng.graphs.captures != caps + 2:
        fail(f"lifecycle (segment raise): {eng.graphs.captures - caps} "
             f"captures, want 2 (before and after the scrub)")
    if eng.pool.available() != eng.pool_pages - 1:
        fail("lifecycle (segment raise): the pool did not come back full")
    _clean_health(eng, "segment raise", failed=2, dispatch=1,
                  error="injected")

    # 4. pool_exhaust: transient, then an unfundable anchor on an idle
    #    engine, shed after admit_retries
    eng.reset()
    inj = eng.injector = FaultInjector(Fault("pool_exhaust", count=3))
    got = _by_rid(_drive(eng, mk(shapes)))
    eng.injector = None
    if inj.fired != [("pool_exhaust", None)] * 3:
        fail(f"lifecycle (pool_exhaust): fired {inj.fired}")
    for rid in B:
        exact(got[rid].tokens, B[rid], f"pool_exhaust, rid {rid}")
    _clean_health(eng, "pool_exhaust")
    eng.reset()
    eng.admit_retries = 3
    inj = eng.injector = FaultInjector(Fault("pool_exhaust", count=100))
    got = _by_rid(_drive(eng, mk(shapes[:1])))
    eng.injector, eng.admit_retries = None, kw.get("admit_retries", 8)
    if (inj.fired != [("pool_exhaust", None)] * 4
            or got[0].status != "shed" or got[0].tokens.size
            or eng.pool.available() != eng.pool_pages - 1):
        fail(f"lifecycle (unfundable anchor): fired {len(inj.fired)}, "
             f"status {got[0].status}")
    _clean_health(eng, "unfundable anchor")

    # 5. cancel: queued, chunking member, resident; then a resident
    #    cancel beside a co-resident slot
    eng.reset()
    res, clock = [], lambda: 0.0
    reqs = mk(shapes)
    for r in reqs:
        eng.submit(r)
    ok = [not eng.cancel(99), eng.cancel(2), not eng.cancel(2)]
    eng.admit_ready(clock, res)               # rid 0 + 1 start chunking
    ok.append(eng.cancel(1))
    while not any(s is not None and s.req.rid == 0 for s in eng._slot):
        eng.admit_ready(clock, res)
        eng.step_prefill(clock, res)
    eng._step_decode(clock, res)
    eng._step_decode(clock, res)
    ok.append(eng.cancel(0))
    res += _drive(eng, [], clock)
    got = _by_rid(res)
    if not all(ok) or statuses(got.values()) != {
            0: "cancelled", 1: "cancelled", 2: "cancelled"} or len(res) != 3:
        fail(f"lifecycle (cancel): {ok}, {statuses(res)}")
    if got[1].tokens.size or got[2].tokens.size:
        fail("lifecycle (cancel): a queued or chunking request kept tokens")
    prefix(got[0].tokens, B[0], "cancel, the resident request")
    eng.reset()
    res = []
    for r in mk([(600, 48), (650, 48)]):
        eng.submit(r)
    while not all(s is not None for s in eng._slot):
        eng.admit_ready(clock, res)
        eng.step_prefill(clock, res)
    eng._step_decode(clock, res)
    eng.cancel(0)
    got = _by_rid(res + _drive(eng, [], clock))
    if got[0].status != "cancelled" or got[1].status != "ok":
        fail(f"lifecycle (cancel beside a co-resident slot): "
             f"{statuses(got.values())}")
    exact(got[1].tokens, B[1], "cancel, the co-resident slot")
    _clean_health(eng, "cancel")

    # 6. deadlines: one expires mid-decode, one in the queue
    eng.reset()
    t = [0.0]
    clock = lambda: t[0]
    res = []
    reqs = mk([(600, 80), (650, 48)])
    reqs[0].deadline_s = 5.0
    for r in reqs:
        eng.submit(r)
    while not any(s is not None and s.req.rid == 0 for s in eng._slot):
        eng.admit_ready(clock, res)
        eng.step_prefill(clock, res)
    eng._step_decode(clock, res)
    eng._step_decode(clock, res)
    t[0] = 10.0
    got = _by_rid(res + _drive(eng, [], clock))
    if (got[0].status, got[1].status) != ("timeout", "ok") or \
            got[0].deadline_s != 5.0:
        fail(f"lifecycle (deadline mid-decode): {statuses(got.values())}")
    prefix(got[0].tokens, B[0], "deadline, the expired request")
    exact(got[1].tokens, B[1], "deadline, the co-resident slot")
    eng.reset()
    t[0] = 0.0
    r = mk([(600, 8)])[0]
    r.deadline_s = 2.0
    eng.submit(r)
    t[0] = 3.0
    res = []
    eng.admit_ready(clock, res)
    if [(x.rid, x.status, x.tokens.size) for x in res] != [(0, "timeout",
                                                            0)]:
        fail(f"lifecycle (deadline in the queue): {statuses(res)}")
    _clean_health(eng, "deadlines")

    # 7. queue_cap under each shed policy
    eng.reset()
    small = [(300, 8)] * 4
    for policy, pri, shed, kept in (
            ("reject", None, [2, 3], [0, 1]),
            ("oldest", None, [0, 1], [2, 3]),
            ("lowest-priority", (1, 0, 2, 0), [1, 3], [0, 2])):
        eng.queue_cap, eng.shed_policy = 2, policy
        reqs = mk(small)
        for i, r in enumerate(reqs):
            r.priority = 0 if pri is None else pri[i]
            eng.submit(r)
        pend = sorted(x.rid for x in eng._pending)
        queued = [x.rid for x in eng.queue]
        got = _by_rid(_drive(eng, []))
        if (pend != shed or queued != kept
                or any(got[i].status != "shed" for i in shed)
                or any(got[i].status != "ok" for i in kept)):
            fail(f"lifecycle (queue_cap, {policy}): shed {pend}, queued "
                 f"{queued}, {statuses(got.values())}")
    eng.queue_cap, eng.shed_policy = None, "reject"
    _clean_health(eng, "queue_cap")

    # 8. slow_segment trips the watchdog
    eng.reset()
    inj = eng.injector = FaultInjector(Fault("slow_segment", after=7,
                                             delay_s=0.5))
    got = _by_rid(_drive(eng, mk([(600, 81)])))
    eng.injector = None
    h = eng.health()
    if (inj.fired != [("slow_segment", None)] or h["watchdog_slow"] < 1
            or got[0].status != "ok"
            or not bool((got[0].tokens[:40] == B[0]).all())):
        fail(f"lifecycle (slow_segment): fired {inj.fired}, watchdog "
             f"{h['watchdog_slow']}, {got[0].status}")
    _clean_health(eng, "slow_segment")
    out["median_segment_ms"] = h["median_segment_s"] * 1e3
    del eng
    torch.cuda.empty_cache()

    # 9. telemetry, a probe every segment: the tokens of telemetry=None,
    #    and every leaf of the resident cache as it was after a probe
    tel = Telemetry(sample_every=1)
    eng = ContinuousEngine(cfg, params, telemetry=tel, **kw)
    got = _by_rid(_drive(eng, mk(shapes)))
    for rid in B:
        exact(got[rid].tokens, B[rid], f"telemetry, rid {rid}")
    if eng.stats["probe_steps"] == 0:
        fail("lifecycle (telemetry): the probe never ran")
    eng.reset()
    for r in mk(shapes[:2]):
        eng.submit(r)
    res = []
    while not all(s is not None for s in eng._slot):
        eng.admit_ready(lambda: 0.0, res)
        eng.step_prefill(lambda: 0.0, res)
    leaves = [t for grp in eng._caches["groups"] for sub in grp.values()
              for _, t in sorted(sub["attn"].items())]
    before = [t.clone() for t in leaves]
    serve.reset_launch_counts()
    eng._sparsity_probe("kernel")
    torch.cuda.synchronize()
    k4 = serve.launch_counts()["K4"]
    same = all(torch.equal(a, b) for a, b in zip(before, leaves))
    if not same or k4 != cfg.n_layers:
        fail(f"lifecycle (probe): cache unchanged {same}, K4 {k4}")
    _drive(eng, [])
    _clean_health(eng, "telemetry")

    # 10. after warmup a mixed run captures no graph and records no new
    #     compile event (but zero_pages/seed, bounded by id counts)
    eng.warmup([600, 650, 300])
    caps, n_ev = eng.graphs.captures, tel.compile_count()
    mixed = mk([(620, 12), (310, 20), (980, 9), (290, 16), (700, 8)])
    got = _by_rid(_drive(eng, mixed))
    fresh = [p for p, _, _ in tel.compiles[n_ev:]
             if p not in ("zero_pages", "seed")]
    if (eng.graphs.captures != caps or fresh
            or any(r.status != "ok" for r in got.values())):
        fail(f"lifecycle (warmup): {eng.graphs.captures - caps} captures, "
             f"new compile events {fresh}")
    _clean_health(eng, "warmup")
    progs = sorted({p for p, _, _ in tel.compiles})
    print(f"lifecycle 15a: 2-layer full-width yi_6b f32, paged, kernel, "
          f"graphed: nan_logits fails only its slot ({out['nan_tokens']} "
          f"of 48 tokens kept), dispatch x2 exact, a raising segment "
          f"scrubbed and recaptured, pool_exhaust x3 exact, an unfundable "
          f"anchor shed after 3 retries, cancel (queued, chunking, "
          f"resident), deadlines (queue, mid-decode), queue_cap under "
          f"reject/oldest/lowest-priority, slow_segment tripped the "
          f"watchdog (median segment {out['median_segment_ms']:.2f} ms), "
          f"telemetry tokens == plain, the probe left the cache bitwise, "
          f"no capture after warmup: all passed in "
          f"{time.monotonic() - t0:.1f} s [{card}]")
    print("  compile events: " + ", ".join(
        f"{p} {tel.compile_count(p)}" for p in progs), flush=True)
    del eng, params, tel
    torch.cuda.empty_cache()
    return out


def _prom_statuses(text: str) -> dict:
    """Per-status request counts from Prometheus text."""
    out = {}
    for line in text.splitlines():
        if line.startswith('serving_requests_total{status="'):
            st = line.split('"')[1]
            out[st] = int(float(line.rsplit(" ", 1)[1]))
    return out


# 15b-c's depth: 16 of yi_6b's 32 layers since phase 21 joined the run,
# 8 since phase 25 did
LIFECYCLE_LAYERS = 8


def lifecycle_slice(torch, seed: int, card: str) -> dict:
    """15b. yi_6b at full width (``LIFECYCLE_LAYERS`` of its 32 layers,
    bf16, random weights from
    ``seed``), phase 6's workload (8 requests, prompts 1152-3670, 16-64
    new, all queued at the start; 4 paged slots, max_len 8192, chunk 512,
    segments of 16, kernel path).  Three runs each of a plain engine
    (telemetry=None) and a traced one (Telemetry(sample_every=16), its
    trace and Prometheus text written), interleaved, on one set of
    weights: goodput, latency, TTFT and launches of each, the median
    traced/plain goodput ratio (printed, not gated), the probe's ms, the
    trace's and the text's bytes, the sparsity sample; the text's
    per-status counts must equal summarize()'s.  Then, on the plain engine
    under queue_cap 4 with the oldest shed, a run with no deadline times
    the four survivors, and the lifecycle run puts the deadline in the
    middle of the widest span in which a survivor is resident with more
    than one segment to run, and cancels another resident request
    mid-decode: every non-ok result must carry the status its cause
    gives, at least one request must time out mid-decode with partial
    tokens, and the pool must come back full.
    15c. The same workload on a dense cache, once plain and once with
    ``spec=4`` whose proposer is injected to fail three times: the engine
    degrades to plain segments, every request is ok, and the tokens'
    agreement with the plain run is printed (bf16 co-residents)."""
    import os
    import statistics
    import numpy as np
    from repro_torch.configs.base import cut_layers, get_config
    from repro_torch.inference.config import ServingConfig
    from repro_torch.inference.faults import Fault, FaultInjector
    from repro_torch.inference.scheduler import (ContinuousEngine,
                                                 summarize,
                                                 synthetic_workload)
    from repro_torch.inference.telemetry import Telemetry
    from repro_torch.launch import serve
    from repro_torch.models.transformer import init_model
    cfg = cut_layers(get_config("yi_6b"), LIFECYCLE_LAYERS)
    nl = cfg.n_layers
    params = init_model(seed, cfg)
    c = ServingConfig(max_len=8192, long_context=True, dsa_mode="kernel",
                      slots=4, seg_len=16, chunk_tokens=512, paged=True)

    def workload():
        return synthetic_workload(8, rate_rps=1e9, prompt_lens=(1024, 4096),
                                  n_new_range=(16, 64), vocab=cfg.vocab,
                                  seed=seed)

    tel = Telemetry(sample_every=16)
    engines = {"plain": ContinuousEngine(cfg, params, config=c),
               "traced": ContinuousEngine(
                   cfg, params, config=dataclasses.replace(c, telemetry=tel))}
    runs = {"plain": [], "traced": []}
    traced_counts = {}                    # summarize()'s, over traced runs
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tel_")
    t0 = time.monotonic()
    for i in range(3):
        for name in ("plain", "traced"):
            eng = engines[name]
            r = _serve_counted(eng, workload())
            st, n = r["stats"], r["launches"]
            summ = r["summary"]
            probes = st.get("probe_steps", 0)
            want = {"K3": nl * st["chunks"],
                    "K4": nl * (st["decode_steps"] + probes)}
            got = {k: v for k, v in n.items() if v}
            if got != want or st["failed"] or st["dispatch_failures"]:
                fail(f"lifecycle slice ({name} run {i}): launches {got}, "
                     f"want {want}, failed {st['failed']}, dispatch "
                     f"failures {st['dispatch_failures']}")
            row = {"summary": summ, "K3": n["K3"], "K4": n["K4"],
                   "decode_steps": st["decode_steps"], "chunks": st["chunks"],
                   "probe_steps": probes, "probe_s": st.get("probe_s", 0.0)}
            if name == "traced":
                tp = os.path.join(tmp, f"trace{i}.json")
                mp = os.path.join(tmp, f"metrics{i}.prom")
                tel.write_chrome_trace(tp)
                tel.write_prometheus(mp)
                with open(mp) as f:
                    text = f.read()
                # the registry accumulates over the engine's runs
                prom = _prom_statuses(text)
                for s_ in ("ok", "timeout", "cancelled", "failed", "shed"):
                    if summ[f"n_{s_}"]:
                        traced_counts[s_] = (traced_counts.get(s_, 0)
                                             + summ[f"n_{s_}"])
                if prom != traced_counts:
                    fail(f"lifecycle slice: Prometheus per-status counts "
                         f"{prom} != summarize()'s {traced_counts}")
                row.update(trace_events=len(tel.events),
                           trace_bytes=os.path.getsize(tp),
                           prom_bytes=os.path.getsize(mp), prom=prom)
            runs[name].append(row)
            extra = ""
            if name == "traced":
                extra = (f", {probes} probes "
                         f"({row['probe_s'] * 1e3 / max(probes, 1):.1f} ms "
                         f"each), {row['trace_events']} trace events "
                         f"({row['trace_bytes']} bytes), Prometheus "
                         f"{row['prom_bytes']} bytes, per status "
                         f"{row['prom']}")
            print(f"lifecycle slice ({name} {i}): goodput "
                  f"{summ['goodput_tok_s']} tok/s, latency p50 "
                  f"{summ['p50_latency_s']} / p95 {summ['p95_latency_s']} s, "
                  f"TTFT p50 {summ['p50_ttft_s']} / p95 {summ['p95_ttft_s']} "
                  f"s, K3 {n['K3']}, K4 {n['K4']} ({st['decode_steps']} "
                  f"decode steps){extra}", flush=True)
    med = {k: statistics.median(x["summary"]["goodput_tok_s"] for x in v)
           for k, v in runs.items()}
    ratio = med["traced"] / med["plain"]
    print(f"lifecycle slice: median goodput plain {med['plain']} / traced "
          f"{med['traced']} tok/s, traced/plain {ratio:.4f} (the reference "
          f"gates >= 0.95 on its own benchmark; printed here) [{card}]")

    def hist(name):
        v = tel.metrics.value(name)
        return v if isinstance(v, tuple) else (0, 0.0)

    # one more traced run with a probe after every segment: the sparsity
    # sample at full width (one in 16 segments gives a handful)
    eng = engines.pop("traced")
    tel.reset()
    tel.sample_every = 1
    r = _serve_counted(eng, workload())
    st, summ = r["stats"], r["summary"]
    sp = {k: hist(f"serving_dsa_{k}") for k in ("keep_rate", "block_churn",
                                                "layer_overlap")}
    prom = _prom_statuses(tel.prometheus_text())
    if (prom != {"ok": summ["n_ok"]} or not sp["keep_rate"][0]
            or not 0.0 < sp["keep_rate"][1] <= 1.0
            or r["launches"]["K4"] != nl * (st["decode_steps"]
                                            + st["probe_steps"])):
        fail(f"lifecycle slice (probe every segment): per status {prom}, "
             f"sparsity {sp}, K4 {r['launches']['K4']}, {st['decode_steps']}"
             f" steps, {st['probe_steps']} probes")
    print(f"  probe every segment: goodput {summ['goodput_tok_s']} tok/s, "
          f"{st['probe_steps']} probes of "
          f"{st['probe_s'] * 1e3 / max(st['probe_steps'], 1):.1f} ms; "
          f"sparsity at full width: keep rate {sp['keep_rate'][0]} samples, "
          f"mean {sp['keep_rate'][1]:.4f}; churn {sp['block_churn'][0]} "
          f"samples, mean {sp['block_churn'][1]:.4f}; layer overlap "
          f"{sp['layer_overlap'][0]} samples, mean "
          f"{sp['layer_overlap'][1]:.4f}", flush=True)
    runs["probe_every_segment"] = {"summary": summ, "sparsity": sp,
                                   "probe_steps": st["probe_steps"],
                                   "probe_s": st["probe_s"]}
    del eng, r, tel

    # the lifecycle runs, on the plain engine, under queue_cap 4 with the
    # oldest shed: the four first arrivals are shed by the last four
    eng = engines.pop("plain")
    eng.queue_cap, eng.shed_policy = 4, "oldest"

    def lifecycle_run(avoid=None):
        """Serve the workload on the wall clock; with ``avoid`` set,
        cancel the first resident request with tokens that is not
        ``avoid`` at the first segment boundary where there is one."""
        res, cancelled = [], None
        ts = time.monotonic()
        clock = lambda: time.monotonic() - ts
        for r in workload():
            eng.submit(r)
        while eng.has_work():
            eng.admit_ready(clock, res)
            eng.step_prefill(clock, res)
            if any(s is not None for s in eng._slot):
                eng._step_decode(clock, res)
            if avoid is not None and cancelled is None:
                live = [s for s in eng._slot if s is not None
                        and s.collected and s.req.rid != avoid]
                if live:
                    cancelled = live[0].req.rid
                    eng.cancel(cancelled, clock())
        res.extend(eng._pending)
        eng._pending.clear()
        return res, cancelled

    # first with no deadline and no cancel: the survivors' own first-token
    # and finish times.  The deadline then falls in the middle of the
    # widest span in which a survivor is resident with more than one
    # segment still to run, so that survivor must time out mid-decode
    pre, _ = lifecycle_run()
    seg_s = eng.health()["median_segment_s"]
    surv = [r for r in pre if r.status == "ok"]
    if (sorted(r.rid for r in surv) != [4, 5, 6, 7]
            or any(r.tokens.size != r.n_new for r in surv)
            or sorted(r.rid for r in pre if r.status == "shed")
            != [0, 1, 2, 3]):
        fail(f"lifecycle run (queue_cap 4, oldest, no deadline): "
             f"{[(r.rid, r.status, r.tokens.size) for r in pre]}")
    span = {r.rid: (r.ttft_s, r.latency_s - seg_s) for r in surv}
    target = max(span, key=lambda k: span[k][1] - span[k][0])
    deadline = sum(span[target]) / 2
    print(f"lifecycle run (queue_cap 4, oldest shed, no deadline): "
          f"survivors' (TTFT, latency) s "
          + ", ".join(f"rid {r.rid} ({r.ttft_s:.3f}, {r.latency_s:.3f})"
                      for r in surv)
          + f"; median segment {seg_s:.4f} s; deadline {deadline:.3f} s, "
          f"inside rid {target}'s decode", flush=True)
    eng.deadline_s = deadline
    res, cancelled = lifecycle_run(avoid=target)
    h = eng.health()
    summ = summarize(res, max(r.finish_s for r in res))
    by = _by_rid(res)
    bad = []
    for r in res:
        if r.rid in (0, 1, 2, 3):         # shed by the 5th to 8th arrivals
            want = r.status == "shed" and r.tokens.size == 0
        elif r.rid == cancelled:
            want = (r.status == "cancelled"
                    and 0 < r.tokens.size < r.n_new)
        elif r.status == "timeout":
            want = r.latency_s > deadline and r.tokens.size < r.n_new
        else:
            want = r.status == "ok" and r.tokens.size == r.n_new
        if not want:
            bad.append((r.rid, r.status, r.tokens.size))
    resident_timeouts = [r.rid for r in res if r.status == "timeout"
                         and 0 < r.tokens.size < r.n_new]
    if (len(by) != 8 or bad or cancelled is None or not resident_timeouts
            or eng.pool.available() != eng.pool_pages - 1 or h["failed"]
            or h["dispatch_failures"] or h["last_error"] is not None):
        fail(f"lifecycle run: {len(by)} results, wrong statuses {bad}, "
             f"cancelled {cancelled}, timed out mid-decode "
             f"{resident_timeouts}, pool free {eng.pool.available()} of "
             f"{eng.pool_pages - 1}, health {h}")
    print(f"lifecycle run (deadline {deadline:.3f} s, queue_cap 4, oldest "
          f"shed, rid {cancelled} cancelled mid-decode, rids "
          f"{resident_timeouts} timed out mid-decode, the pool back "
          f"full): "
          + ", ".join(f"{k[2:]} {summ[k]}" for k in
                      ("n_ok", "n_timeout", "n_cancelled", "n_failed",
                       "n_shed"))
          + f"; SLO attainment {summ['slo_attainment']}; goodput "
          f"{summ['goodput_tok_s']} tok/s; health {h}", flush=True)
    out = {"runs": runs, "ratio": ratio, "lifecycle": summ, "health": h}
    del eng
    torch.cuda.empty_cache()

    # 15c. speculation with a failing proposer, on a dense cache
    cd = dataclasses.replace(c, paged=False)
    eng = ContinuousEngine(cfg, params, config=cd)
    plain = _serve_counted(eng, workload())
    del eng
    torch.cuda.empty_cache()
    eng = ContinuousEngine(cfg, params, config=dataclasses.replace(cd,
                                                                   spec=4))
    inj = eng.injector = FaultInjector(Fault("proposer", count=3))
    spec = _serve_counted(eng, workload())
    h = eng.health()
    st, n = spec["stats"], spec["launches"]
    want = {"K1": nl * st["decode_steps"], "K3": nl * st["chunks"]}
    got = {k: v for k, v in n.items() if v}
    toks = {r.rid: r.tokens for r in spec["results"]}
    ref = {r.rid: r.tokens for r in plain["results"]}
    share = (sum(int((toks[k] == ref[k]).sum()) for k in ref)
             / sum(len(v) for v in ref.values()))
    if (inj.fired != [("proposer", None)] * 3 or not h["spec_degraded"]
            or h["proposer_failures"] != 3 or st["spec_rounds"]
            or got != want or h["failed"] or h["dispatch_failures"]
            or "proposer" not in (h["last_error"] or "")):
        fail(f"lifecycle 15c: fired {inj.fired}, health {h}, spec rounds "
             f"{st['spec_rounds']}, launches {got}, want {want}")
    print(f"lifecycle 15c (dense, spec 4, proposer injected x3): degraded "
          f"{h['spec_degraded']}, {st['spec_rounds']} rounds, "
          f"{st['decode_steps']} plain steps, every request ok, goodput "
          f"{spec['summary']['goodput_tok_s']} tok/s (plain engine "
          f"{plain['summary']['goodput_tok_s']}), K1 {n['K1']}, K3 "
          f"{n['K3']}; tokens equal to the plain engine's at "
          f"{share:.4f} of positions (bf16 co-residents, printed) [{card}]",
          flush=True)
    out["spec"] = {"share": share, "health": h}
    print(f"phase 15b/c: {time.monotonic() - t0:.1f} s", flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    del eng, params
    torch.cuda.empty_cache()
    return out


# -- phase 16: checkpoints, RWKV6 training, dots, yi_6b training --------------


def _grads_close(torch, got, want, rel: float) -> tuple:
    """Largest |got - want| over each gradient leaf's largest magnitude,
    and whether every leaf is equal bit for bit."""
    from repro_torch.tree import named_leaves
    want = dict(named_leaves(want))
    worst, bitwise = 0.0, True
    for path, g in named_leaves(got):
        w = want[path]
        scale = max(float(w.abs().max()), 1e-12)
        worst = max(worst, float((g - w).abs().max()) / scale)
        bitwise = bitwise and bool(torch.equal(g, w))
    return worst, bitwise


def rwkv_train_parity_phase(torch, seed: int) -> dict:
    """16a.  rwkv6_3b at full width (d 2560, 40 heads of 64, vocab 65536),
    2 layers, f32: one train step (``lm_batches``, batch 2 x 512, 2
    microbatches; the differentiable chunked wkv, 16 chunks) on the card
    and on the CPU from the same params, gated as ``train_parity_phase``
    (mse is 0: no DSA), no kernel launched in it.  Then the eval step on
    the trained model launches K7 once a layer and gives the train
    form's ce within f32's tolerance (rtol 1e-5).  Then stablelm_3b, 2
    layers, f32, one microbatch of 2 x 512: the gradients under
    ``remat_policy="dots"`` against "full" within 1e-4 of each leaf's
    largest magnitude (the backward's ``index_add`` sums in no fixed
    order), with each policy's peak memory."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.synthetic import DataConfig, lm_batches
    from repro_torch.launch import serve
    from repro_torch.optim import adamw
    from repro_torch.training import steps as ST
    from repro_torch.tree import named_leaves
    t0 = time.monotonic()
    cfg = dataclasses.replace(get_config("rwkv6_3b"), n_layers=2,
                              dtype="float32", param_dtype="float32")
    opt = adamw.OptConfig(lr=1e-3, total_steps=10, warmup_steps=2)
    batch = next(lm_batches(DataConfig(vocab=cfg.vocab, seq_len=512,
                                       global_batch=2, seed=seed)))
    card, _ = ST.init_train_state(seed, cfg, opt)
    cpu_params = to_cpu(card["params"])
    cpu = {"params": cpu_params, "opt": adamw.init(opt, cpu_params),
           "step": 0}
    step = ST.make_train_step(cfg, opt, microbatches=2)
    serve.reset_launch_counts()
    card, m_card = step(card, batch)
    m_card = {k: float(v) for k, v in m_card.items()}
    n = {k: v for k, v in serve.launch_counts().items() if v}
    cpu, m_cpu = step(cpu, batch)
    m_cpu = {k: float(v) for k, v in m_cpu.items()}
    rel = {k: abs(m_card[k] - m_cpu[k]) / abs(m_cpu[k])
           for k in ("loss", "ce", "grad_norm")}
    lr = m_cpu["lr"]
    want = dict(named_leaves(cpu["params"]))
    worst, within, total = 0.0, 0, 0
    for path, p in named_leaves(card["params"]):
        d = (p.detach().cpu() - want[path].detach()).abs()
        worst = max(worst, float(d.max()))
        within += int((d <= 1e-5).sum())
        total += d.numel()
    print(f"16a rwkv train parity: 2-layer full-width rwkv6_3b f32, batch 2 "
          f"x 512, 2 microbatches: card vs CPU relative differences "
          + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
          + f" (rtol {TRAIN_METRIC_RTOL:g}), mse {m_card['mse']} / "
          f"{m_cpu['mse']}; new params max |d| {worst:.3g} (bound 2 lr = "
          f"{2 * lr:.3g}), {100 * within / total:.3f} % within 1e-5; "
          f"kernels launched: {n or 'none'}", flush=True)
    print(f"  card: {', '.join(f'{k} {m_card[k]:.6f}' for k in rel)}")
    print(f"  cpu : {', '.join(f'{k} {m_cpu[k]:.6f}' for k in rel)}")
    if (n or worst > 2 * lr or within < TRAIN_PARAM_SHARE * total
            or max(rel.values()) > TRAIN_METRIC_RTOL
            or m_card["mse"] != 0.0):
        fail("rwkv6_3b training parity (card vs CPU) failed")
    del cpu, cpu_params
    serve.reset_launch_counts()
    ev = float(ST.make_eval_step(cfg)(card["params"], batch)["ce"])
    n_eval = {k: v for k, v in serve.launch_counts().items() if v}
    serve.reset_launch_counts()
    dev = card["params"]["embed"].device
    on = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    _, m = ST.loss_fn(card["params"], cfg, ST.default_flags(cfg), on)
    tr = float(m["ce"].detach())
    n_train = {k: v for k, v in serve.launch_counts().items() if v}
    same = abs(ev - tr) <= 1e-5 * abs(tr)
    print(f"16a rwkv eval on the trained model: ce eval (K7) {ev:.7f}, train "
          f"form {tr:.7f} (rtol 1e-5: {same}); launches eval {n_eval}, "
          f"train form {n_train or 'none'}", flush=True)
    if not same or n_eval != {"K7": cfg.n_layers} or n_train:
        fail(f"rwkv6_3b eval: ce {ev} vs {tr}, launches {n_eval}, "
             f"{n_train}")
    del card, m
    torch.cuda.empty_cache()

    # dots against full
    sl = dataclasses.replace(get_config("stablelm_3b"), n_layers=2,
                             dtype="float32", param_dtype="float32")
    batch = next(lm_batches(DataConfig(vocab=sl.vocab, seq_len=512,
                                       global_batch=2, seed=seed)))
    params = ST.init_train_state(seed, sl, adamw.OptConfig())[0]["params"]
    grads, peak = {}, {}
    for pol in ("full", "dots"):
        c = dataclasses.replace(sl, remat=True, remat_policy=pol)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        grads[pol], _ = ST.accumulate_grads(params, c, ST.default_flags(c),
                                            batch)
        torch.cuda.synchronize()
        peak[pol] = (torch.cuda.max_memory_allocated() - held) / 2**30
    err, bitwise = _grads_close(torch, grads["dots"], grads["full"], 1e-4)
    print(f"16a dots vs full: 2-layer full-width stablelm_3b f32, 2 x 512: "
          f"gradients max |d| / leaf max {err:.3g} (bound 1e-4), bitwise "
          f"{bitwise}; peak memory above the params: full {peak['full']:.3f} "
          f"GiB, dots {peak['dots']:.3f} GiB", flush=True)
    if err > 1e-4:
        fail("remat_policy dots: gradients differ from full")
    del params, grads
    torch.cuda.empty_cache()
    print(f"phase 16a: {time.monotonic() - t0:.1f} s", flush=True)
    return {"rel": rel, "eval_ce": ev, "train_ce": tr, "dots_err": err,
            "dots_bitwise": bitwise, "peak_gib": peak}


def _same_bits(a, b) -> bool:
    import numpy as np
    return (a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        np.ascontiguousarray(a).reshape(-1).view(np.uint8),
        np.ascontiguousarray(b).reshape(-1).view(np.uint8)))


def _state_diff(torch, a, b) -> tuple:
    """The share of elements of two states' tensors that differ, and the
    largest |difference| of the params."""
    from repro_torch.tree import named_leaves
    bl = dict(named_leaves(b))
    diff = total = 0
    worst = 0.0
    for path, x in named_leaves(a):
        if not isinstance(x, torch.Tensor):
            continue
        d = (x.detach().float() - bl[path].detach().float()).abs()
        diff += int((d != 0).sum())
        total += d.numel()
        if path.startswith("/params/"):
            worst = max(worst, float(d.max()))
    return diff / total, worst


# 16b's depth: 4 layers until phase 22 joined the run, 2 since
CKPT_LAYERS = 2


def checkpoint_phase(torch, seed: int) -> dict:
    """16b.  stablelm_3b at full width with ``CKPT_LAYERS`` layers (bf16
    params, f32 moments), 4 steps of 2 x 512 tokens: an uninterrupted run saves at
    step 2 (``AsyncCheckpointer``, into a temporary directory removed
    afterwards); a state made from another seed restores that checkpoint,
    equal bit for bit to the state saved, and runs steps 2-3 on the same
    batches.  A second uninterrupted run gives the tolerance: the resumed
    run's metrics agree with the first run's within twice the two
    uninterrupted runs' largest relative difference (at least 1e-5), and
    its params and moments differ in no more than twice their share of
    differing elements (at least 1 %).  Prints whether it is bitwise, the
    bytes on disk and the host-copy, write and restore seconds."""
    from repro_torch import convert
    from repro_torch.checkpoint import checkpoint as C
    from repro_torch.configs.base import get_config
    from repro_torch.data.synthetic import DataConfig, lm_batches
    from repro_torch.optim import adamw
    from repro_torch.training import steps as ST
    from repro_torch.tree import named_leaves
    t0 = time.monotonic()
    cfg = dataclasses.replace(get_config("stablelm_3b"),
                              n_layers=CKPT_LAYERS)
    opt = adamw.OptConfig(lr=1e-3, total_steps=4, warmup_steps=1)
    data = lm_batches(DataConfig(vocab=cfg.vocab, seq_len=512,
                                 global_batch=2, seed=seed))
    batches = [next(data) for _ in range(4)]
    step = ST.make_train_step(cfg, opt)

    def run(state, first, last):
        out = []
        for i in range(first, last):
            state, m = step(state, batches[i])
            out.append({k: float(v) for k, v in m.items()})
        return state, out

    out = {}
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        ck = C.AsyncCheckpointer(tmp)
        a, ma = run(ST.init_train_state(seed, cfg, opt)[0], 0, 2)
        torch.cuda.synchronize()
        snap = convert.state_to_reference(a)
        t = time.perf_counter()
        ck.save(a, 2)
        copy_s = time.perf_counter() - t
        ck.wait()
        write_s = time.perf_counter() - t - copy_s
        path = Path(tmp) / "ckpt_2"
        nbytes = sum(f.stat().st_size for f in path.iterdir())
        a, mb = run(a, 2, 4)
        ma += mb
        b, mb2 = run(ST.init_train_state(seed, cfg, opt)[0], 0, 4)
        other, _ = ST.init_train_state(seed + 1, cfg, opt)
        torch.cuda.synchronize()
        t = time.perf_counter()
        r, rstep = C.restore(str(path), other)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        del other
        again = dict(named_leaves(convert.state_to_reference(r)))
        exact = rstep == 2 and all(_same_bits(again[k], v)
                                   for k, v in named_leaves(snap))
        del again, snap
        frozen = all(not p.requires_grad
                     for k, p in named_leaves(r["params"])
                     if k.endswith("/dsa/p"))
        r, mr = run(r, 2, 4)
    keys = ("loss", "ce", "mse", "grad_norm")

    def mrel(x, y):
        return max(abs(p[k] - q[k]) / abs(q[k]) for p, q in zip(x, y)
                   for k in keys)
    d_ab, d_ra = mrel(mb2, ma), mrel(mr, ma[2:])
    s_ab, w_ab = _state_diff(torch, b, a)
    s_ra, w_ra = _state_diff(torch, r, a)
    bitwise = d_ra == 0 and s_ra == 0
    ok = (exact and frozen and d_ra <= max(2 * d_ab, 1e-5)
          and s_ra <= max(2 * s_ab, 0.01))
    print(f"16b checkpoint: {CKPT_LAYERS}-layer full-width stablelm_3b (bf16 "
          f"params, f32 moments), {nbytes:,} bytes on disk; host copy {copy_s:.3f} s "
          f"(blocks the loop), write {write_s:.3f} s, restore "
          f"{restore_s:.3f} s; restored == saved bit for bit: {exact}, P "
          f"frozen: {frozen}; two uninterrupted runs: metrics max rel "
          f"{d_ab:.3g}, {100 * s_ab:.4f} % of state elements differ, "
          f"params max |d| {w_ab:.3g}; resumed (from seed {seed + 1}) vs "
          f"uninterrupted: metrics max rel {d_ra:.3g}, {100 * s_ra:.4f} % "
          f"differ, params max |d| {w_ra:.3g}; bitwise: {bitwise}",
          flush=True)
    print("  uninterrupted: " + "; ".join(
        f"{m['loss']:.5f}" for m in ma) + "  resumed steps 2-3: "
        + "; ".join(f"{m['loss']:.5f}" for m in mr))
    if not ok:
        fail("checkpoint: the restored state or the resumed run differs")
    del a, b, r
    torch.cuda.empty_cache()
    out = {"bytes": nbytes, "copy_s": copy_s, "write_s": write_s,
           "restore_s": restore_s, "bitwise": bitwise}
    print(f"phase 16b: {time.monotonic() - t0:.1f} s", flush=True)
    return out


def _train_report(torch, label: str, cfg, state, metrics, step_s, b: int,
                  s: int, mb: int, n: dict, peak: float) -> dict:
    """Print and gate a full-width training run: the median step time over
    steps 2 on, tokens/s, the 6 N D share of the bf16 peak (N: the
    blocks' params, a dense prologue's and an encoder's included, and
    the lm head's; the embedding lookup and the remat recompute are not
    counted), peak memory; every metric finite and no kernel launched."""
    import math
    import statistics
    from repro_torch.tree import named_leaves
    med = statistics.median(step_s[1:])
    leaves = list(named_leaves(state["params"]))
    n_blocks = sum(p.numel() for k, p in leaves
                   if k.startswith(("/groups/", "/prologue/",
                                    "/enc_groups/")))
    n_head = state["params"]["lm_head"].numel()
    share = 6 * (n_blocks + n_head) * b * s / med / PEAK_FLOPS["bfloat16"]
    finite = all(math.isfinite(v) for m in metrics for v in m.values())
    print(f"{label} ({len(step_s)} steps of {b} x {s} in {mb} "
          f"microbatches): step {med * 1e3:.1f} ms (median of steps "
          f"2-{len(step_s)}; all: "
          + ", ".join(f"{t * 1e3:.1f}" for t in step_s)
          + f" ms), {b * s / med:.0f} tok/s; 6 N D / step time / 989 "
          f"TFLOP/s = 6 x {n_blocks + n_head:,} x {b * s} / {med:.4f} s / "
          f"989e12 = {100 * share:.2f} %; peak memory {peak:.2f} GiB; "
          f"losses " + ", ".join(f"{m['loss']:.4f}" for m in metrics)
          + f"; metrics finite: {finite}; kernels launched: {n or 'none'}",
          flush=True)
    if n or not finite:
        fail(f"{label}: launched {n}, metrics finite {finite}")
    return {"step_ms": med * 1e3, "tok_s": b * s / med, "mfu_6nd": share,
            "peak_gib": peak, "microbatches": mb}


def _profiled_step(torch, label: str, step, state, batch) -> tuple:
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        float(m["loss"])
        wall = time.perf_counter() - t0
    tr = _device_time(prof, "train", 1)
    _print_profile(label, wall * 1e3, *tr)
    return wall * 1e3, tr[0], tr[1]


def rwkv_train_slice(torch, seed: int, layers: int = 8) -> dict:
    """16c.  rwkv6_3b at full width through ``repro_torch.launch.train``:
    ``layers`` of its 32 layers (8 since phase 21 joined the run) in
    bf16, remat, 4 steps of 4 x 4096 tokens in 2 microbatches (the
    differentiable chunked wkv, 128 chunks), no kernel launched; then one
    profiled step, and the eval step on the trained model, which
    launches K7 once a layer (its count is the K7 row's "rwkv eval"
    path)."""
    import math
    from repro_torch.configs.base import cut_layers, get_config
    from repro_torch.data.synthetic import DataConfig, lm_batches
    from repro_torch.launch import serve, train
    from repro_torch.optim import adamw
    from repro_torch.training import steps as ST
    t0 = time.monotonic()
    cfg = cut_layers(get_config("rwkv6_3b"), layers)
    b, s, steps = 4, 4096, 4
    torch.cuda.empty_cache()
    serve.reset_launch_counts()
    res = train.main(["--arch", "rwkv6_3b", "--layers", str(layers),
                      "--steps", str(steps), "--seq",
                      str(s), "--batch", str(b), "--microbatches", "2",
                      "--data", "lm", "--log-interval", "1", "--seed",
                      str(seed)])
    n = {k: v for k, v in serve.launch_counts().items() if v}
    peak = torch.cuda.max_memory_allocated() / 2**30
    out = _train_report(torch, f"16c rwkv train slice (rwkv6_3b, {layers} "
                        f"layers bf16, remat)", cfg, res.state, res.metrics,
                        res.step_s, b, s, 2, n, peak)
    opt = adamw.OptConfig(total_steps=steps + 2, warmup_steps=1)
    batch = next(lm_batches(DataConfig(vocab=cfg.vocab, seq_len=s,
                                       global_batch=b, seed=seed + 1)))
    step = ST.make_train_step(cfg, opt, microbatches=2)
    serve.reset_launch_counts()
    out["profile"] = _profiled_step(
        torch, f"rwkv6_3b train step ({b} x {s}, 2 microbatches)", step,
        res.state, batch)
    n = {k: v for k, v in serve.launch_counts().items() if v}
    serve.reset_launch_counts()
    ev = ST.make_eval_step(cfg)(res.state["params"], batch)
    out["eval_ce"] = float(ev["ce"])
    out["launches"] = serve.launch_counts()
    print(f"16c rwkv eval step on the trained model ({b} x {s}): ce "
          f"{out['eval_ce']:.5f}; launches "
          + " ".join(f"{k} {v}" for k, v in out["launches"].items() if v)
          + f"; the profiled train step launched {n or 'none'}", flush=True)
    if n or out["launches"]["K7"] != cfg.n_layers or not math.isfinite(
            out["eval_ce"]):
        fail(f"16c: eval launches {out['launches']}, train step {n}")
    del res, step, ev
    torch.cuda.empty_cache()
    print(f"phase 16c: {time.monotonic() - t0:.1f} s", flush=True)
    return out


# 16d's depth, and 22b's and 24a's, which read its run: 8 of yi_6b's 32
# layers since phase 21 joined the run, 4 since phase 25 did
YI_TRAIN_LAYERS = 4


def yi_train_slice(torch, seed: int,
                   layers: int = YI_TRAIN_LAYERS) -> dict:
    """16d.  yi_6b at full width (``layers`` of its 32 layers; bf16,
    remat, DSA block path) with bf16
    moments (``OptConfig(moment_dtype="bfloat16")``: 6 bytes a
    parameter with the gradients) through ``steps.make_train_step``: 4
    steps of 4 x 4096 tokens in 2 microbatches, or 4 where 2 run out of
    memory; every metric finite, P unchanged, no kernel launched; then one
    profiled step."""
    from repro_torch.configs.base import cut_layers, get_config
    from repro_torch.data.synthetic import DataConfig, lm_batches
    from repro_torch.launch import serve
    from repro_torch.optim import adamw
    from repro_torch.training import steps as ST
    from repro_torch.tree import named_leaves
    t0 = time.monotonic()
    cfg = cut_layers(get_config("yi_6b"), layers)
    b, s, steps = 4, 4096, 4
    opt = adamw.OptConfig(moment_dtype="bfloat16", total_steps=steps + 1,
                          warmup_steps=1)
    data = lm_batches(DataConfig(vocab=cfg.vocab, seq_len=s, global_batch=b,
                                 seed=seed))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state, _ = ST.init_train_state(seed, cfg, opt)
    p0 = {k: v.clone() for k, v in _p_leaves(state["params"]).items()}
    serve.reset_launch_counts()
    metrics, step_s, mb = [], [], 2
    batch = next(data)
    while len(step_s) < steps:
        step = ST.make_train_step(cfg, opt, microbatches=mb)
        try:
            t = time.perf_counter()
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
            step_s.append(time.perf_counter() - t)
            batch = next(data)
        except torch.cuda.OutOfMemoryError:
            if mb == b or metrics:
                raise
            print(f"16d: {mb} microbatches ran out of memory; taking {b}",
                  flush=True)
            for _, p in named_leaves(state["params"]):
                p.grad = None
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            mb = b
    n = {k: v for k, v in serve.launch_counts().items() if v}
    peak = torch.cuda.max_memory_allocated() / 2**30
    out = _train_report(torch, f"16d yi train slice (yi_6b, {layers} layers "
                        f"bf16, bf16 moments, remat, DSA block)", cfg, state,
                        metrics, step_s, b, s, mb, n, peak)
    out["losses"] = [m["loss"] for m in metrics]
    out["profile"] = _profiled_step(
        torch, f"yi_6b train step ({b} x {s}, {mb} microbatches)", step,
        state, next(data))
    frozen = all(torch.equal(p0[k], v)
                 for k, v in _p_leaves(state["params"]).items())
    n = {k: v for k, v in serve.launch_counts().items() if v}
    print(f"16d: P unchanged after {steps + 1} updates: {frozen}; kernels "
          f"launched: {n or 'none'}", flush=True)
    if not frozen or n:
        fail("16d: P moved or a kernel launched")
    del state, p0
    torch.cuda.empty_cache()
    print(f"phase 16d: {time.monotonic() - t0:.1f} s", flush=True)
    return out


# -- mixture of experts: mixtral_8x22b -------------------------------------------

# the MoE layer card against CPU (f32, reduced width): of the largest
# magnitude of y (and of the aux), the summation orders of the two devices'
# products
MOE_REL = 1e-5
MIXTRAL_LAYERS = 8            # 17b's depth: 8 x 4.9 GB of bf16 experts


def _moe_card_vs_cpu(torch) -> dict:
    """Reduced mixtral's MoE layer (f32, capacity factor 1.0 so that the
    capacity route drops pairs) on the card and on the CPU from the same
    weights and inputs: the dispatch positions equal, y and the router
    term within MOE_REL of the largest magnitude on the capacity and the
    decode-dense routes."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models import moe
    cfg = reduced(get_config("mixtral_8x22b"))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=1.0))
    gen = torch.Generator().manual_seed(0)
    params = moe.init_moe(gen, cfg, device="cpu")
    dev = {k: v.cuda() for k, v in params.items()}
    b, s = 4, 96
    x = torch.randn((b, s, cfg.d_model), generator=gen)
    out = {}
    for route, decode in (("capacity", False), ("dense", True)):
        y, a = moe.apply_moe(params, cfg, x, decode=decode)
        dy, da = moe.apply_moe(dev, cfg, x.cuda(), decode=decode)
        out[route] = max(
            float((dy.cpu() - y).abs().max()) / float(y.abs().max()),
            abs(float(da["router"]) - float(a["router"]))
            / abs(float(a["router"])))
    # each row's dispatch, as the capacity route makes it
    cap = max(4, int(s * cfg.moe.top_k * 1.0 / cfg.moe.num_experts))
    out.update(positions_equal=True, dropped=0, pairs=0)
    for row in x:
        e = moe._route(params["router"], row,
                       cfg.moe.top_k)[0].reshape(-1).long()
        pos = moe._dispatch_positions(e, cfg.moe.num_experts, cap)
        out["positions_equal"] &= bool(torch.equal(moe._dispatch_positions(
            e.cuda(), cfg.moe.num_experts, cap).cpu(), pos))
        out["dropped"] += int((pos >= cap).sum())
        out["pairs"] += int(pos.numel())
    return out


def mixtral_parity_phase(torch, seed: int, card: str, n_new: int = 16,
                         prompt_len: int = 4352) -> dict:
    """17a.  mixtral_8x22b at full width, 2 layers, f32, prompts of 4352
    tokens (the 4096-token ring wraps at prefill and in decode), batch 2:
    the kernel path (K2 with the window, once a layer) gives the block
    path's greedy tokens; the graphed scan loop the eager python loop's;
    ``moe_prefill="dense"`` runs (K2 once a layer); the continuous engine
    (blocking admission into a dense ring, 2 slots, 4 requests) gives each
    request its solo ``generate`` tokens; and the MoE layer at reduced
    width on the card equals the CPU's (``_moe_card_vs_cpu``)."""
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.inference.engine import Engine
    from repro_torch.inference.scheduler import ContinuousEngine, Request
    from repro_torch.kernels.dsa_attention import dsa_block_sparse_attention
    from repro_torch.models.transformer import init_model
    t0 = time.monotonic()
    cfg = dataclasses.replace(get_config("mixtral_8x22b"), n_layers=2,
                              dtype="float32", param_dtype="float32")
    params = init_model(seed, cfg)
    rng = np.random.default_rng(seed)
    prompts = rng.integers(1, cfg.vocab - 4, size=(2, prompt_len)).astype(
        np.int32)
    max_len = prompt_len + n_new + 16
    toks, k2 = {}, {}
    captures = 0
    for name, kw in (("block", dict(dsa_mode="block")),
                     ("kernel", dict(dsa_mode="kernel")),
                     ("eager", dict(dsa_mode="kernel", loop="python")),
                     ("dense prefill", dict(dsa_mode="kernel",
                                            moe_prefill="dense"))):
        before = dsa_block_sparse_attention.launches
        eng = Engine(cfg, params, max_len=max_len, long_context=True, **kw)
        toks[name] = eng.generate(prompts, n_new).tokens
        k2[name] = dsa_block_sparse_attention.launches - before
        if name == "kernel":
            captures = eng.graphs.captures
        del eng
        torch.cuda.empty_cache()
    want_k2 = {"block": 0, "kernel": 2, "eager": 2, "dense prefill": 2}
    same_k = bool((toks["kernel"] == toks["block"]).all())
    graphed = bool((toks["kernel"] == toks["eager"]).all()) and captures == 1
    dense_same = float((toks["dense prefill"] == toks["kernel"]).mean())
    shapes = [(prompt_len, 16), (prompt_len, 12), (4200, 16), (3000, 10)]
    reqs = [Request(i, rng.integers(1, cfg.vocab - 4, size=(n,)).astype(
        np.int32), m) for i, (n, m) in enumerate(shapes)]
    eng = ContinuousEngine(cfg, params, slots=2, seg_len=4, max_len=max_len,
                           long_context=True, dsa_mode="kernel")
    got = _run_clean(eng, reqs)
    chunked = eng.chunked
    del eng
    solo = Engine(cfg, params, max_len=max_len, long_context=True,
                  dsa_mode="kernel")
    cont = all(bool((got[r.rid] == solo.generate(
        r.prompt[None], r.n_new).tokens[0]).all()) for r in reqs)
    del solo, params
    torch.cuda.empty_cache()
    layer = _moe_card_vs_cpu(torch)
    print(f"17a parity: 2-layer full-width mixtral_8x22b f32, prompt "
          f"{prompt_len}, {n_new} new: kernel (K2 with window, "
          f"{k2['kernel']} launches a prefill) == block: {same_k}; graphed "
          f"scan == eager python loop: {graphed} ({captures} capture); "
          f"moe_prefill='dense' ran (K2 {k2['dense prefill']}; "
          f"{100 * dense_same:.1f} % of its tokens equal the capacity "
          f"prefill's); continuous (blocking, dense ring, "
          f"{len(reqs)} requests) == solo generate: {cont}; MoE layer card "
          f"vs CPU at reduced width, f32: capacity (cf 1.0, "
          f"{layer['dropped']} of {layer['pairs']} pairs dropped, "
          f"positions equal: {layer['positions_equal']}) "
          f"{layer['capacity']:.2e}, decode-dense {layer['dense']:.2e} of "
          f"the largest magnitude (limit {MOE_REL:g}); "
          f"{time.monotonic() - t0:.1f} s [{card}]", flush=True)
    for k, t in toks.items():
        print(f"  {k:14s}: {t[:, :8].tolist()}")
    if not (same_k and graphed and cont and not chunked
            and k2 == want_k2 and layer["positions_equal"]
            and layer["dropped"] > 0
            and max(layer["capacity"], layer["dense"]) <= MOE_REL):
        fail(f"17a mixtral parity failed: K2 {k2}, chunked {chunked}")
    return {"kernel_block": same_k, "graphed": graphed, "continuous": cont,
            "layer": layer, "k2": k2}


def _timed_decode(torch, step, tok, steps: int) -> tuple:
    """Run ``steps`` greedy steps from ``tok``; (ms a step on the host
    clock around a synchronised run, the last token)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        tok = step(tok)[:, -1].argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3, tok


def mixtral_slice(torch, seed: int, card: str) -> dict:
    """17b.  mixtral_8x22b at full width, MIXTRAL_LAYERS layers, bf16
    weights and a bf16 cache (so the residual stream stays bf16 through
    decode), random weights from the seed, DSA on the kernel path.  The
    static slice through ``launch.serve`` (batch 4, prompt 8192, 32 new):
    K2 once a layer, no decode kernel; then on one model: the share of
    (token, slot) pairs the capacity prefill dropped, a torch.profiler
    breakdown of the prefill and of a graphed decode step, one eager
    decode step on the default f32 cache, and the continuous engine (4
    slots, 8 requests of 4096-8192 tokens in whole blocks and 16-32 new,
    all queued at the start, blocking admission into the ring, K2 once a
    layer an admission)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import get_config
    from repro_torch.inference.engine import Engine
    from repro_torch.inference.scheduler import (ContinuousEngine, Request,
                                                 summarize)
    from repro_torch.launch import serve
    from repro_torch.models import moe
    from repro_torch.models import transformer as TT
    from repro_torch.models.attention import RunFlags
    t0 = time.monotonic()
    cfg = dataclasses.replace(get_config("mixtral_8x22b"),
                              n_layers=MIXTRAL_LAYERS)
    b, plen, n_new = 4, 8192, 32
    max_len = plen + n_new + 16
    torch.cuda.reset_peak_memory_stats()
    serve.reset_launch_counts()
    res = serve.main(["--arch", "mixtral_8x22b", "--layers",
                      str(MIXTRAL_LAYERS), "--batch", str(b), "--prompt-len",
                      str(plen), "--new-tokens", str(n_new), "--dsa",
                      "--dsa-mode", "kernel", "--cache-dtype", "bfloat16",
                      "--seed", str(seed)])
    n = serve.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    flags = RunFlags(mode="decode", long_context=True)
    row = serve.cache_bytes(TT.init_cache(cfg, 1, max_len, flags,
                                          dtype=torch.bfloat16,
                                          device="meta"))
    out = {"prefill_ms": res.prefill_s * 1e3,
           "decode_tok_s": res.tokens_per_s, "peak_gib": peak,
           "cache_bytes_per_row": row, "launches": n}
    tok = res.tokens
    print(f"17b mixtral static slice ({MIXTRAL_LAYERS} layers bf16, bf16 "
          f"cache, batch {b}, prompt {plen}, {n_new} new, kernel path): "
          f"prefill {res.prefill_s * 1e3:.1f} ms, decode "
          f"{res.tokens_per_s:.1f} tok/s over {res.decode_steps} steps "
          f"({res.decode_dispatches} graph replays), peak memory "
          f"{peak:.2f} GiB, cache {row} bytes per batch row, launches "
          + " ".join(f"{k} {v}" for k, v in n.items()) + f" [{card}]",
          flush=True)
    bad = {k: v for k, v in n.items()
           if v != (MIXTRAL_LAYERS if k == "K2" else 0)}
    if (bad or res.decode_dispatches != res.decode_steps
            or tok.shape != (b, n_new) or tok.min() < 0
            or tok.max() >= cfg.vocab):
        fail(f"17b static slice: launches {bad}, tokens {tok.shape}")
    del res
    gc.collect()
    torch.cuda.empty_cache()

    params = TT.init_model(seed, cfg)
    prompts = np.random.default_rng(seed).integers(
        1, cfg.vocab - 4, size=(b, plen)).astype(np.int32)
    eng = Engine(cfg, params, max_len=max_len, long_context=True,
                 dsa_mode="kernel", cache_dtype=torch.bfloat16)
    drops = []
    dispatch = moe._dispatch_positions

    def counting(e_flat, num_experts, cap):
        pos = dispatch(e_flat, num_experts, cap)
        drops.append(((pos >= cap).sum(), pos.numel()))
        return pos

    acts = [ProfilerActivity.CUDA]
    with torch.inference_mode():
        moe._dispatch_positions = counting
        try:
            eng.prefill(prompts)                                 # warm
        finally:
            moe._dispatch_positions = dispatch
        dropped = int(sum(int(d) for d, _ in drops))
        pairs = sum(p for _, p in drops)
        _, _, prefill_s = eng.prefill(prompts)
        with profile(activities=acts) as prof:
            eng.prefill(prompts)
        pre = _device_time(prof, "mixtral_prefill", 1)
        step = eng.scan_step(b)                                  # capture
        last, _, _ = eng.prefill(prompts, caches=eng.resident_cache(b))
        tok = last[:, -1].argmax(-1, keepdim=True)
        _, tok = _timed_decode(torch, step, tok, 2)              # warm
        step_ms, tok = _timed_decode(torch, step, tok, 8)
        with profile(activities=acts) as prof:
            _, tok = _timed_decode(torch, step, tok, 2)
        dec = _device_time(prof, "mixtral_decode", 2)
    _print_profile(f"17b mixtral prefill ({b} x {plen}) [{card}]",
                   prefill_s * 1e3, *pre)
    _print_profile(f"17b mixtral decode step, graph replay (batch {b}) "
                   f"[{card}]", step_ms, *dec)
    # every expert read once a step: the least time a step could take
    expert_bytes = sum(p.numel() * p.element_size()
                       for g in params["groups"]
                       for k, p in g["b0"]["mlp"].items() if k != "router")
    bound_ms = expert_bytes / HBM_BYTES_PER_S * 1e3
    out.update(dropped=dropped, pairs=pairs, prefill_busy_ms=pre[0],
               step_ms=step_ms, step_busy_ms=dec[0],
               expert_bound_ms=bound_ms, capture_ms=step.capture_ms)
    print(f"17b: capacity prefill dropped {dropped} of {pairs} (token, "
          f"slot) pairs ({100 * dropped / pairs:.3f} %); graphed decode step "
          f"{step_ms:.3f} ms (capture {step.capture_ms:.1f} ms) against "
          f"{bound_ms:.3f} ms to read the {expert_bytes / 1e9:.2f} GB of "
          f"experts once at {HBM_BYTES_PER_S / 1e12:.2f} TB/s "
          f"({100 * bound_ms / step_ms:.1f} %) [{card}]", flush=True)
    del eng, step
    torch.cuda.empty_cache()

    # the default f32 cache: the residual stream turns f32 after layer 0
    # and each decode step copies every expert to f32 (ROADMAP Queue 3)
    eng = Engine(cfg, params, max_len=max_len, long_context=True,
                 dsa_mode="kernel", loop="python")
    try:
        with torch.inference_mode():
            caches = eng.resident_cache(b)
            last, _, _ = eng.prefill(prompts, caches=caches)
            tok = last[:, -1].argmax(-1, keepdim=True)

            def eager(t):
                return TT.decode_step(params, cfg, eng.decode_flags, t,
                                      caches)[0]

            torch.cuda.reset_peak_memory_stats()
            _, tok = _timed_decode(torch, eager, tok, 1)         # warm
            f32_ms, tok = _timed_decode(torch, eager, tok, 2)
        f32_peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"17b: one eager decode step on the default f32 cache "
              f"{f32_ms:.3f} ms (peak memory {f32_peak:.2f} GiB) against "
              f"the graphed bf16-cache step's {step_ms:.3f} ms [{card}]",
              flush=True)
        out.update(f32_cache_step_ms=f32_ms, f32_cache_peak_gib=f32_peak)
    except torch.cuda.OutOfMemoryError:
        print(f"17b: the eager decode step on the default f32 cache ran "
              f"out of memory: not measured [{card}]", flush=True)
    del eng
    torch.cuda.empty_cache()

    # prompts of whole 128-token blocks: the block (K2) prefill needs
    # them, another length takes the token path (as in the reference)
    rng = np.random.default_rng(seed + 1)
    reqs = [Request(i, rng.integers(1, cfg.vocab - 4, size=(128 * int(
        rng.integers(32, 65)),)).astype(np.int32),
        int(rng.integers(16, 33))) for i in range(8)]
    ceng = ContinuousEngine(cfg, params, slots=4, seg_len=16,
                            max_len=max_len, long_context=True,
                            dsa_mode="kernel", cache_dtype=torch.bfloat16)
    serve.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    results = ceng.serve(reqs)
    n = serve.launch_counts()
    st = ceng.stats
    summ = summarize(results, max(r.finish_s for r in results))
    cpeak = torch.cuda.max_memory_allocated() / 2**30
    print(f"17b mixtral continuous slice (4 slots, 8 requests, prompts "
          f"{min(len(r.prompt) for r in reqs)}-"
          f"{max(len(r.prompt) for r in reqs)}, blocking admission into "
          f"the ring): {summ['goodput_tok_s']} tok/s goodput, latency p50 "
          f"{summ['p50_latency_s']} s / p95 {summ['p95_latency_s']} s, TTFT "
          f"p50 {summ['p50_ttft_s']} s / p95 {summ['p95_ttft_s']} s, "
          f"{st['segments']} segments, {st['admitted']} admissions, "
          f"{st['decode_steps']} decode steps, peak memory {cpeak:.2f} GiB, "
          f"launches " + " ".join(f"{k} {v}" for k, v in n.items() if v)
          + f" [{card}]", flush=True)
    bad = [r.rid for r in results
           if r.status != "ok" or len(r.tokens) != r.n_new]
    others = {k: v for k, v in n.items() if k != "K2" and v}
    if (len(results) != len(reqs) or bad or others or ceng.chunked
            or n["K2"] == 0 or n["K2"] % MIXTRAL_LAYERS):
        fail(f"17b continuous slice: bad {bad}, launches {n}")
    out["continuous"] = {"summary": summ, "peak_gib": cpeak,
                         "launches": n}
    del ceng, params
    torch.cuda.empty_cache()
    print(f"phase 17b: {time.monotonic() - t0:.1f} s", flush=True)
    return out


def mixtral_train_slice(torch, seed: int, card: str) -> dict:
    """17c.  mixtral_8x22b at full width, 2 layers, through
    ``launch.train``: bf16 params with bf16 moments, remat full, DSA block
    path, 4 steps of 4 x 4096 tokens in 2 microbatches (4 if 2 run out of
    memory); finite metrics, no kernel launched; the step time, tokens/s,
    the 6 N D share of 989 TFLOP/s with N the active parameters (2 of 8
    experts a token) and with all of them, peak memory, the router term;
    then one profiled step."""
    import math
    import statistics
    from repro_torch.configs.base import get_config
    from repro_torch.data.synthetic import DataConfig, lm_batches
    from repro_torch.launch import serve, train
    from repro_torch.optim import adamw
    from repro_torch.training import steps as ST
    t0 = time.monotonic()
    cfg = dataclasses.replace(get_config("mixtral_8x22b"), n_layers=2)
    b, s, steps, mb = 4, 4096, 4, 2
    while True:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        serve.reset_launch_counts()
        try:
            res = train.main([
                "--arch", "mixtral_8x22b", "--layers", "2", "--steps",
                str(steps), "--seq", str(s), "--batch", str(b),
                "--microbatches", str(mb), "--moment-dtype", "bfloat16",
                "--data", "lm", "--log-interval", "1", "--seed", str(seed)])
            break
        except torch.cuda.OutOfMemoryError:
            if mb == b:
                raise
            print(f"17c: {mb} microbatches ran out of memory; taking {b}",
                  flush=True)
        mb = b
    n = {k: v for k, v in serve.launch_counts().items() if v}
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = statistics.median(res.step_s[1:])
    tok_s = b * s / med
    n_act, n_all = cfg.num_active_params(), cfg.num_params()
    share = {k: 6 * v * b * s / med / PEAK_FLOPS["bfloat16"]
             for k, v in (("active", n_act), ("all", n_all))}
    finite = all(math.isfinite(v) for m in res.metrics for v in m.values())
    router = [m["router_aux"] for m in res.metrics]
    opt = adamw.OptConfig(moment_dtype="bfloat16", total_steps=steps + 2,
                          warmup_steps=1)
    batch = next(lm_batches(DataConfig(vocab=cfg.vocab, seq_len=s,
                                       global_batch=b, seed=seed + 1)))
    wall, busy, kernels = _profiled_step(
        torch, f"17c mixtral train step ({b} x {s}, {mb} microbatches) "
        f"[{card}]", ST.make_train_step(cfg, opt, microbatches=mb),
        res.state, batch)
    n2 = {k: v for k, v in serve.launch_counts().items() if v}
    print(f"17c mixtral train slice (2 layers bf16, bf16 moments, remat "
          f"full, DSA block; {steps} steps of {b} x {s} in {mb} "
          f"microbatches): step {med * 1e3:.1f} ms (median of steps "
          f"2-{steps}; all: " + ", ".join(f"{t * 1e3:.1f}"
                                          for t in res.step_s)
          + f" ms), {tok_s:.0f} tok/s; 6 N D / step time / 989 TFLOP/s: "
          f"N active {n_act:,} -> {100 * share['active']:.2f} %, N all "
          f"{n_all:,} -> {100 * share['all']:.2f} %; peak memory "
          f"{peak:.2f} GiB; losses "
          + ", ".join(f"{m['loss']:.4f}" for m in res.metrics)
          + "; router aux " + ", ".join(f"{r:.6f}" for r in router)
          + f"; profiled step busy {100 * busy / wall:.1f} % "
          f"({kernels:.0f} kernels); metrics finite: {finite}; kernels "
          f"launched: {n or n2 or 'none'} [{card}]", flush=True)
    if n or n2 or not finite or not all(r > 0 for r in router):
        fail(f"17c: launched {n or n2}, finite {finite}, router {router}")
    del res
    torch.cuda.empty_cache()
    print(f"phase 17c: {time.monotonic() - t0:.1f} s", flush=True)
    return {"step_ms": med * 1e3, "tok_s": tok_s, "share": share,
            "peak_gib": peak, "microbatches": mb, "router_aux": router,
            "busy_share": busy / wall}


MLA_REL = 1e-4
DEEPSEEK_LAYERS = 5           # 18b's depth: the prologue and 2 MoE layers


def _mla_card_vs_cpu(torch, seed: int) -> float:
    """One full-width deepseek_v3 MLA layer (f32, with its DSA predictor)
    on the card and on the CPU from the same weights and inputs: a 1 x
    256 prefill on the block path, two absorbed decode steps and a 4-row
    verify.  Returns the largest error of any output or cache leaf over
    the largest magnitude of that leaf."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import attention as TAT
    from repro_torch.tree import map_tree
    cfg = get_config("deepseek_v3")
    gen = torch.Generator().manual_seed(seed)
    params = TAT.init_mla(gen, cfg, device="cpu")
    dev = map_tree(lambda t: t.cuda(), params)
    caches = {d: TAT.init_cache_mla(cfg, 1, 384, device=d,
                                    dtype=torch.float32)
              for d in ("cpu", "cuda")}
    worst = 0.0

    def rel(got, want):
        return float((got.cpu() - want).abs().max()) / max(
            float(want.abs().max()), 1e-12)

    def both(flags, s, **kw):
        nonlocal worst
        x = torch.randn((1, s, cfg.d_model), generator=gen)
        outs = [TAT.apply_mla(p, cfg, flags, x.to(d), cache=caches[d],
                              **{k: v.to(d) for k, v in kw.items()})[0]
                for d, p in (("cpu", params), ("cuda", dev))]
        worst = max(worst, rel(outs[1], outs[0]))
        for name in ("c_kv", "k_rope"):
            worst = max(worst, rel(caches["cuda"][name],
                                   caches["cpu"][name]))
        if not torch.equal(caches["cuda"]["pos"].cpu(), caches["cpu"]["pos"]):
            fail("18a: the MLA layer's pos differs between card and CPU")

    with torch.inference_mode():
        both(TAT.RunFlags(mode="prefill", dsa_mode="block"), 256)
        dflags = TAT.RunFlags(mode="decode", dsa_mode="block")
        for _ in range(2):
            both(dflags, 1)
        both(TAT.RunFlags(mode="decode", dsa_mode="block", spec_verify=True),
             4, chunk_len=torch.full((1,), 4, dtype=torch.int32))
    return worst


def deepseek_parity_phase(torch, seed: int, card: str, n_new: int = 16,
                          prompt_len: int = 1024) -> dict:
    """18a.  deepseek_v3 at full width cut to its dense prologue (3
    layers, 3.6 B params) in f32, prompts of 1024 tokens (8 key blocks),
    batch 2: the graphed scan loop gives the eager python loop's greedy
    tokens (one capture); "kernel" gives "block"'s, with no kernel
    launched by either (MLA's prefill is the plain block gather, its
    decode the latent attention); the continuous engine (dense cache,
    blocking admission under block, 2 slots, 4 requests) gives each
    request its solo ``generate`` tokens, as does chunked admission
    under "off" (chunks of 256 tokens) against whole-prompt prefill;
    speculation (off, K 4) gives the plain tokens.  Then one MLA layer
    card == CPU at full width (``_mla_card_vs_cpu``) and reduced
    deepseek_v3 (the MoE layers included) card == CPU in greedy
    tokens."""
    import numpy as np
    from repro_torch.configs.base import cut_layers, get_config, reduced
    from repro_torch.inference.engine import Engine
    from repro_torch.inference.scheduler import ContinuousEngine, Request
    from repro_torch.launch import serve
    from repro_torch.models.transformer import init_model
    from repro_torch.tree import map_tree
    t0 = time.monotonic()
    cfg = dataclasses.replace(cut_layers(get_config("deepseek_v3"), 3),
                              dtype="float32", param_dtype="float32")
    params = init_model(seed, cfg)
    rng = np.random.default_rng(seed)
    prompts = rng.integers(1, cfg.vocab - 4, size=(2, prompt_len)).astype(
        np.int32)
    max_len = prompt_len + n_new + 16
    serve.reset_launch_counts()
    toks, captures = {}, 0
    for name, kw in (("block", dict(dsa_mode="block")),
                     ("kernel", dict(dsa_mode="kernel")),
                     ("eager", dict(dsa_mode="kernel", loop="python"))):
        eng = Engine(cfg, params, max_len=max_len, long_context=True, **kw)
        toks[name] = eng.generate(prompts, n_new).tokens
        if name == "kernel":
            captures = eng.graphs.captures
        del eng
        torch.cuda.empty_cache()
    same_k = bool((toks["kernel"] == toks["block"]).all())
    graphed = bool((toks["kernel"] == toks["eager"]).all()) and captures == 1
    shapes = [(prompt_len, 16), (896, 12), (640, 16), (prompt_len, 10)]
    reqs = [Request(i, rng.integers(1, cfg.vocab - 4, size=(n,)).astype(
        np.int32), m) for i, (n, m) in enumerate(shapes)]
    cont, chunked, chunks = {}, {}, {}
    # an arch with experts chunk-admits under dense MoE prefill only (the
    # prologue has no MoE layer: the option changes nothing else here)
    for mode, kw in (("block", dict(long_context=True)),
                     ("off", dict(moe_prefill="dense"))):
        eng = ContinuousEngine(cfg, params, slots=2, seg_len=4,
                               max_len=max_len, dsa_mode=mode,
                               chunk_tokens=256, **kw)
        got = _run_clean(eng, [dataclasses.replace(r) for r in reqs])
        chunked[mode], chunks[mode] = eng.chunked, eng.stats["chunks"]
        del eng
        solo = Engine(cfg, params, max_len=max_len, dsa_mode=mode, **kw)
        cont[mode] = all(bool((got[r.rid] == solo.generate(
            r.prompt[None], r.n_new).tokens[0]).all()) for r in reqs)
        del solo
        torch.cuda.empty_cache()
    eng = Engine(cfg, params, max_len=max_len)
    plain = eng.generate(prompts, n_new).tokens
    spec = eng.generate(prompts, n_new, spec=4)
    spec_same = bool((spec.tokens == plain).all())
    launched = {k: v for k, v in serve.launch_counts().items() if v}
    del eng, params
    torch.cuda.empty_cache()
    layer = _mla_card_vs_cpu(torch, seed)
    rcfg = reduced(get_config("deepseek_v3"))
    rp = init_model(seed, rcfg, device="cpu")
    rprompts = rng.integers(1, rcfg.vocab - 4, size=(2, 48)).astype(
        np.int32)
    kw = dict(max_len=80, long_context=True, dsa_mode="block")
    rcpu = Engine(rcfg, rp, device="cpu", **kw).generate(rprompts, 8).tokens
    rcard = Engine(rcfg, map_tree(lambda t: t.cuda(), rp), **kw).generate(
        rprompts, 8).tokens
    reduced_same = bool((rcpu == rcard).all())
    print(f"18a parity: 3-layer (the dense prologue) full-width deepseek_v3 "
          f"f32, prompt {prompt_len}, {n_new} new: kernel == block: "
          f"{same_k}; graphed scan == eager python loop: {graphed} "
          f"({captures} capture); continuous (dense, blocking under block, "
          f"{len(reqs)} requests, chunked {chunked['block']}) == solo "
          f"generate: {cont['block']}; chunked admission under off "
          f"({chunks['off']} chunk steps) == whole-prompt prefill: "
          f"{cont['off']}; spec (off, K 4, {spec.spec_rounds} rounds) == "
          f"plain: {spec_same}; kernels launched: {launched or 'none'}; "
          f"one MLA layer card vs CPU at full width, f32: {layer:.2e} of "
          f"the largest magnitude (limit {MLA_REL:g}); reduced deepseek_v3 "
          f"(MoE included) card == CPU greedy tokens: {reduced_same}; "
          f"{time.monotonic() - t0:.1f} s [{card}]", flush=True)
    for k, t in toks.items():
        print(f"  {k:8s}: {t[:, :8].tolist()}")
    if not (same_k and graphed and all(cont.values()) and spec_same
            and not chunked["block"] and chunked["off"] and chunks["off"]
            and not launched and layer <= MLA_REL and reduced_same):
        fail(f"18a deepseek parity failed: launched {launched}, chunked "
             f"{chunked}, chunks {chunks}")
    return {"kernel_block": same_k, "graphed": graphed, "continuous": cont,
            "spec": spec_same, "layer": layer, "reduced": reduced_same}


def deepseek_slice(torch, seed: int, card: str) -> dict:
    """18b and 18c.  deepseek_v3 at full width, DEEPSEEK_LAYERS layers
    (the 3-layer dense prologue and 2 MoE layers of 256 experts, 26.6 B
    params), bf16 weights on a bf16 cache, random weights from the seed.
    18b, the static slice through ``launch.serve`` (batch 4, prompt 4096,
    32 new, dsa_mode "kernel"): no kernel launched (MLA prefill is the
    plain block gather, decode the latent attention), a graph replay a
    step; then on one model: the share of (token, slot) pairs the
    capacity prefill dropped, a torch.profiler breakdown of the prefill
    and of a graphed decode step against the time to read the step's
    weights once.  18c, the continuous engine (4 slots, dense cache,
    max_len 8192, blocking admission): 8 requests of 1024-4096 tokens in
    whole 128-token blocks and 16-64 new, all queued at the start."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import cut_layers, get_config
    from repro_torch.inference.engine import Engine
    from repro_torch.inference.scheduler import (ContinuousEngine, Request,
                                                 summarize)
    from repro_torch.launch import serve
    from repro_torch.models import moe
    from repro_torch.models import transformer as TT
    from repro_torch.models.attention import RunFlags
    t0 = time.monotonic()
    cfg = cut_layers(get_config("deepseek_v3"), DEEPSEEK_LAYERS)
    b, plen, n_new = 4, 4096, 32
    max_len = plen + n_new + 16
    torch.cuda.reset_peak_memory_stats()
    serve.reset_launch_counts()
    res = serve.main(["--arch", "deepseek_v3", "--layers",
                      str(DEEPSEEK_LAYERS), "--batch", str(b),
                      "--prompt-len", str(plen), "--new-tokens", str(n_new),
                      "--dsa", "--dsa-mode", "kernel", "--cache-dtype",
                      "bfloat16", "--seed", str(seed)])
    n = serve.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    row = serve.cache_bytes(TT.init_cache(
        cfg, 1, max_len, RunFlags(mode="decode", long_context=True),
        dtype=torch.bfloat16, device="meta"))
    out = {"prefill_ms": res.prefill_s * 1e3,
           "decode_tok_s": res.tokens_per_s, "peak_gib": peak,
           "cache_bytes_per_row": row, "launches": n}
    tok = res.tokens
    print(f"18b deepseek_v3 static slice ({DEEPSEEK_LAYERS} layers bf16, "
          f"bf16 cache, batch {b}, prompt {plen}, {n_new} new, "
          f"dsa_mode kernel): prefill {res.prefill_s * 1e3:.1f} ms, decode "
          f"{res.tokens_per_s:.1f} tok/s over {res.decode_steps} steps "
          f"({res.decode_dispatches} graph replays), peak memory "
          f"{peak:.2f} GiB, cache {row} bytes per batch row, launches "
          + " ".join(f"{k} {v}" for k, v in n.items()) + f" [{card}]",
          flush=True)
    if (any(n.values()) or res.decode_dispatches != res.decode_steps
            or tok.shape != (b, n_new) or tok.min() < 0
            or tok.max() >= cfg.vocab):
        fail(f"18b static slice: launches {n}, tokens {tok.shape}")
    del res
    gc.collect()
    torch.cuda.empty_cache()

    params = TT.init_model(seed, cfg)
    prompts = np.random.default_rng(seed).integers(
        1, cfg.vocab - 4, size=(b, plen)).astype(np.int32)
    eng = Engine(cfg, params, max_len=max_len, long_context=True,
                 dsa_mode="kernel", cache_dtype=torch.bfloat16)
    drops = []
    dispatch = moe._dispatch_positions

    def counting(e_flat, num_experts, cap):
        pos = dispatch(e_flat, num_experts, cap)
        drops.append(((pos >= cap).sum(), pos.numel()))
        return pos

    acts = [ProfilerActivity.CUDA]
    with torch.inference_mode():
        moe._dispatch_positions = counting
        try:
            eng.prefill(prompts)                                 # warm
        finally:
            moe._dispatch_positions = dispatch
        dropped = int(sum(int(d) for d, _ in drops))
        pairs = sum(p for _, p in drops)
        _, _, prefill_s = eng.prefill(prompts)
        with profile(activities=acts) as prof:
            eng.prefill(prompts)
        pre = _device_time(prof, "deepseek_prefill", 1)
        step = eng.scan_step(b)                                  # capture
        last, _, _ = eng.prefill(prompts, caches=eng.resident_cache(b))
        tok = last[:, -1].argmax(-1, keepdim=True)
        _, tok = _timed_decode(torch, step, tok, 2)              # warm
        step_ms, tok = _timed_decode(torch, step, tok, 8)
        with profile(activities=acts) as prof:
            _, tok = _timed_decode(torch, step, tok, 2)
        dec = _device_time(prof, "deepseek_decode", 2)
    _print_profile(f"18b deepseek_v3 prefill ({b} x {plen}) [{card}]",
                   prefill_s * 1e3, *pre)
    _print_profile(f"18b deepseek_v3 decode step, graph replay (batch {b}) "
                   f"[{card}]", step_ms, *dec)
    # a decode step reads every weight once but the embedding table
    from repro_torch.tree import named_leaves
    w_bytes = sum(p.numel() * p.element_size()
                  for k, p in named_leaves(params) if k != "/embed")
    bound_ms = w_bytes / HBM_BYTES_PER_S * 1e3
    out.update(dropped=dropped, pairs=pairs, prefill_busy_ms=pre[0],
               step_ms=step_ms, step_busy_ms=dec[0], weight_bound_ms=bound_ms,
               capture_ms=step.capture_ms)
    print(f"18b: capacity prefill dropped {dropped} of {pairs} (token, "
          f"slot) pairs ({100 * dropped / pairs:.3f} %); graphed decode step "
          f"{step_ms:.3f} ms (device busy {dec[0]:.3f} ms, capture "
          f"{step.capture_ms:.1f} ms) against {bound_ms:.3f} ms to read the "
          f"{w_bytes / 1e9:.2f} GB of weights once at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s ({100 * bound_ms / step_ms:.1f}"
          f" %) [{card}]", flush=True)
    del eng, step
    torch.cuda.empty_cache()

    rng = np.random.default_rng(seed + 1)
    reqs = [Request(i, rng.integers(1, cfg.vocab - 4, size=(128 * int(
        rng.integers(8, 33)),)).astype(np.int32),
        int(rng.integers(16, 65))) for i in range(8)]
    ceng = ContinuousEngine(cfg, params, slots=4, seg_len=16, max_len=8192,
                            long_context=True, dsa_mode="kernel",
                            cache_dtype=torch.bfloat16)
    serve.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    results = ceng.serve(reqs)
    n = serve.launch_counts()
    st = ceng.stats
    summ = summarize(results, max(r.finish_s for r in results))
    cpeak = torch.cuda.max_memory_allocated() / 2**30
    print(f"18c deepseek_v3 continuous slice (4 slots, dense cache, max_len "
          f"8192, 8 requests, prompts {min(len(r.prompt) for r in reqs)}-"
          f"{max(len(r.prompt) for r in reqs)}, blocking admission): "
          f"{summ['goodput_tok_s']} tok/s goodput, latency p50 "
          f"{summ['p50_latency_s']} s / p95 {summ['p95_latency_s']} s, TTFT "
          f"p50 {summ['p50_ttft_s']} s / p95 {summ['p95_ttft_s']} s, "
          f"{st['segments']} segments, {st['admitted']} admissions, "
          f"{st['decode_steps']} decode steps, peak memory {cpeak:.2f} GiB, "
          f"launches {({k: v for k, v in n.items() if v}) or 'none'} "
          f"[{card}]", flush=True)
    bad = [r.rid for r in results
           if r.status != "ok" or len(r.tokens) != r.n_new]
    if len(results) != len(reqs) or bad or any(n.values()) or ceng.chunked:
        fail(f"18c continuous slice: bad {bad}, launches {n}")
    out["continuous"] = {"summary": summ, "peak_gib": cpeak}
    del ceng, params
    torch.cuda.empty_cache()
    print(f"phase 18b-c: {time.monotonic() - t0:.1f} s", flush=True)
    return out


def deepseek_train_slice(torch, seed: int, card: str) -> dict:
    """18d.  deepseek_v3 at full width cut to its dense prologue (3 MLA
    layers with 18432-wide SwiGLUs, 3.6 B params) through
    ``launch.train``: bf16 params with f32 moments, remat full, DSA block
    path, 4 steps of 4 x 4096 tokens in 2 microbatches; finite metrics,
    no kernel launched, the MSE term in the loss; the step time, tokens/s,
    the 6 N D share of 989 TFLOP/s, peak memory, then one profiled step
    (busy share, kernel count).  (Training with the experts at this width
    does not fit one card: ROADMAP Queue 1, "Distribution".)"""
    from repro_torch.configs.base import cut_layers, get_config
    from repro_torch.data.synthetic import DataConfig, lm_batches
    from repro_torch.launch import serve, train
    from repro_torch.optim import adamw
    from repro_torch.training import steps as ST
    t0 = time.monotonic()
    cfg = cut_layers(get_config("deepseek_v3"), 3)
    b, s, steps, mb = 4, 4096, 4, 2
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    serve.reset_launch_counts()
    res = train.main(["--arch", "deepseek_v3", "--layers", "3", "--steps",
                      str(steps), "--seq", str(s), "--batch", str(b),
                      "--microbatches", str(mb), "--data", "lm",
                      "--log-interval", "1", "--seed", str(seed)])
    n = {k: v for k, v in serve.launch_counts().items() if v}
    peak = torch.cuda.max_memory_allocated() / 2**30
    rep = _train_report(torch, f"18d deepseek_v3 train slice (3 layers: "
                        f"the dense prologue, bf16, f32 moments, remat "
                        f"full, DSA block) [{card}]", cfg, res.state,
                        res.metrics, res.step_s, b, s, mb, n, peak)
    opt = adamw.OptConfig(total_steps=steps + 2, warmup_steps=1)
    batch = next(lm_batches(DataConfig(vocab=cfg.vocab, seq_len=s,
                                       global_batch=b, seed=seed + 1)))
    wall, busy, kernels = _profiled_step(
        torch, f"18d deepseek_v3 train step ({b} x {s}, {mb} microbatches) "
        f"[{card}]", ST.make_train_step(cfg, opt, microbatches=mb),
        res.state, batch)
    mse = [m["mse"] for m in res.metrics]
    n2 = {k: v for k, v in serve.launch_counts().items() if v}
    print(f"18d: mse " + ", ".join(f"{v:.4f}" for v in mse)
          + f"; profiled step busy {100 * busy / wall:.1f} % "
          f"({kernels:.0f} kernels); kernels launched: {n2 or 'none'} "
          f"[{card}]", flush=True)
    if n2 or not all(v > 0 for v in mse) or len(res.step_s) != steps:
        fail(f"18d: launched {n2}, mse {mse}, {len(res.step_s)} steps")
    del res
    torch.cuda.empty_cache()
    print(f"phase 18d: {time.monotonic() - t0:.1f} s", flush=True)
    return dict(rep, busy_share=busy / wall, kernels=kernels)


MAMBA_REL = 1e-4
JAMBA_LAYERS = 5              # 19b-c: [m, m+MoE, m, m+MoE, a], 48.2 GB bf16


def _mamba_card_vs_cpu(torch, seed: int) -> dict:
    """One full-width jamba_1_5_large Mamba block (d 8192, mi 16384,
    state 16; f32) on the card and on the CPU from the same weights and
    inputs: a 1 x 1024 prefill into a cache (eight 128-token chunks of
    the scan), then 16 one-token decode steps.  Returns the largest
    error of the outputs and of ``h`` and ``conv`` over the largest
    magnitude of each, and the seconds each side took."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import ssm
    cfg = get_config("jamba_1_5_large")
    gen = torch.Generator().manual_seed(seed)
    params = ssm.init_mamba(gen, cfg, device="cpu")
    dev = {k: v.cuda() for k, v in params.items()}
    caches = {d: ssm.init_cache_mamba(cfg, 1, device=d, dtype=torch.float32)
              for d in ("cpu", "cuda")}
    xs = [torch.randn((1, 1024, cfg.d_model), generator=gen)] + [
        torch.randn((1, 1, cfg.d_model), generator=gen) for _ in range(16)]
    out = {"y": 0.0, "h": 0.0, "conv": 0.0, "cpu_s": 0.0, "card_s": 0.0}

    def rel(got, want):
        return float((got.cpu() - want).abs().max()) / max(
            float(want.abs().max()), 1e-12)

    with torch.inference_mode():
        for i, x in enumerate(xs):
            ys = {}
            for d, p in (("cpu", params), ("cuda", dev)):
                t0 = time.perf_counter()
                ys[d] = ssm.apply_mamba(p, cfg, x.to(d), cache=caches[d],
                                        decode=i > 0)
                if d == "cuda":
                    torch.cuda.synchronize()
                out[f"{'card' if d == 'cuda' else d}_s"] += (
                    time.perf_counter() - t0)
            out["y"] = max(out["y"], rel(ys["cuda"], ys["cpu"]))
            for k in ("h", "conv"):
                out[k] = max(out[k], rel(caches["cuda"][k],
                                         caches["cpu"][k]))
    return out


@contextlib.contextmanager
def _prefill_calls(eng):
    """Count a continuous engine's blocking prefills (``eng.engine.
    prefill`` calls) in the list it yields.  The counting wrapper holds
    the engine, so it is taken off again on the way out: left in place,
    it would keep the engine, its cache and its weights alive until the
    cyclic collector ran."""
    calls = []
    real = eng.engine.prefill

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    eng.engine.prefill = counted
    try:
        yield calls
    finally:
        del eng.engine.prefill


def _graph_bits(torch, eng, prompts, steps: int = 4, extras=None) -> bool:
    """The engine's graphed decode step against the eager step on a copy
    of the same cache: ``steps`` steps from one prefill (with ``extras``,
    an encoder or image input), logits and every cache leaf (the cross
    sub-layers' ``ck``/``cv`` too) equal bit for bit."""
    from repro_torch.models.transformer import (attn_caches, cross_caches,
                                                decode_step)
    from repro_torch.tree import map_tree
    b = prompts.shape[0]
    step = eng.scan_step(b)                       # capture before prefill
    last, res, _ = eng.prefill(prompts, caches=eng.resident_cache(b),
                               extras=extras)
    with torch.inference_mode():
        twin = map_tree(lambda t: t.clone(), res)
        tok = last[:, -1].argmax(-1, keepdim=True)
        same = True
        for _ in range(steps):
            g = step(tok).clone()
            e = decode_step(eng.params, eng.mcfg, eng.decode_flags, tok,
                            twin)[0]
            same &= bool(torch.equal(g, e))
            tok = g[:, -1].argmax(-1, keepdim=True)
        for a, c in zip([*attn_caches(res), *cross_caches(res)],
                        [*attn_caches(twin), *cross_caches(twin)]):
            same &= all(bool(torch.equal(a[k], c[k])) for k in a)
    return same


def jamba_parity_phase(torch, seed: int, card: str) -> dict:
    """19a.  One full-width Mamba block card == CPU
    (``_mamba_card_vs_cpu``).  Reduced jamba_1_5_large (the reference's
    one group of 8: 4 Mamba, attention, 3 Mamba; MoE on b1, b3, b5, b7)
    in f32 on the card, prompts of 256 (two chunks of the scan, 16 key
    blocks), batch 2: the kernel path (K2 once a prefill, K1 once a
    decode step: one attention layer) gives the block path's greedy
    tokens, the graphed scan loop the eager python loop's (one capture)
    and ``_graph_bits`` holds; the continuous engine (blocking admission,
    2 slots, 4 requests, two of one length) gives each request its solo
    ``generate`` tokens; the CPU gives the card's tokens.  Then rwkv6_3b
    at full width, 2 layers, f32: the continuous engine (2 slots, 4
    requests of 512-1024 tokens in whole 32-token chunks) gives each its
    solo tokens, K7 once a layer per blocking prefill."""
    import numpy as np
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.inference.engine import Engine
    from repro_torch.inference.scheduler import ContinuousEngine, Request
    from repro_torch.launch import serve
    from repro_torch.models.transformer import init_model
    from repro_torch.tree import map_tree
    t0 = time.monotonic()
    layer = _mamba_card_vs_cpu(torch, seed)
    worst = max(layer[k] for k in ("y", "h", "conv"))
    print(f"19a Mamba block card vs CPU: full-width jamba_1_5_large (d 8192, "
          f"mi 16384, state 16), f32, 1 x 1024 prefill then 16 decode "
          f"steps: y {layer['y']:.2e}, h {layer['h']:.2e}, conv "
          f"{layer['conv']:.2e} of the largest magnitude (limit "
          f"{MAMBA_REL:g}); card {layer['card_s']:.2f} s, CPU "
          f"{layer['cpu_s']:.2f} s [{card}]", flush=True)
    cfg = reduced(get_config("jamba_1_5_large"))
    params = init_model(seed, cfg)
    rng = np.random.default_rng(seed)
    prompts = rng.integers(1, cfg.vocab - 4, size=(2, 256)).astype(np.int32)
    n_new, max_len = 16, 256 + 32
    kw = dict(max_len=max_len, long_context=True)
    toks, n, captures = {}, {}, 0
    for name, extra in (("block", dict(dsa_mode="block")),
                        ("kernel", dict(dsa_mode="kernel")),
                        ("eager", dict(dsa_mode="kernel", loop="python"))):
        serve.reset_launch_counts()
        eng = Engine(cfg, params, **kw, **extra)
        res = eng.generate(prompts, n_new)
        toks[name] = res.tokens
        n[name] = {k: v for k, v in serve.launch_counts().items() if v}
        if name == "kernel":
            captures = eng.graphs.captures
            steps = res.decode_steps
    same_k = bool((toks["kernel"] == toks["block"]).all())
    graphed = bool((toks["kernel"] == toks["eager"]).all()) and captures == 1
    bits = _graph_bits(torch, Engine(cfg, params, dsa_mode="kernel", **kw),
                       prompts)
    shapes = [(256, 16), (256, 12), (200, 16), (128, 10)]
    reqs = [Request(i, rng.integers(1, cfg.vocab - 4, size=(m,)).astype(
        np.int32), k) for i, (m, k) in enumerate(shapes)]
    ceng = ContinuousEngine(cfg, params, slots=2, seg_len=4,
                            dsa_mode="kernel", **kw)
    got = _run_clean(ceng, reqs)
    solo = Engine(cfg, params, dsa_mode="kernel", **kw)
    cont = all(bool((got[r.rid] == solo.generate(
        r.prompt[None], r.n_new).tokens[0]).all()) for r in reqs)
    cpu = Engine(cfg, map_tree(lambda t: t.cpu(), params), device="cpu",
                 dsa_mode="kernel", **kw).generate(prompts, n_new).tokens
    card_cpu = bool((cpu == toks["kernel"]).all())
    chunked = ceng.chunked
    del eng, ceng, solo, params
    torch.cuda.empty_cache()
    want_n = {"block": {}, "kernel": {"K2": 1, "K1": steps},
              "eager": {"K2": 1, "K1": n_new - 1}}
    print(f"19a parity: reduced jamba_1_5_large (8 sub-blocks) f32, prompt "
          f"256, {n_new} new: kernel == block: {same_k} (launches "
          f"{n}); graphed scan == eager python loop: {graphed} ({captures} "
          f"capture); graphed step == eager step bit for bit (logits and "
          f"every cache leaf, 4 steps): {bits}; continuous (blocking, "
          f"{len(reqs)} requests, chunked {chunked}) == solo "
          f"generate: {cont}; card == CPU tokens: {card_cpu} "
          f"[{card}]", flush=True)
    for k, t in toks.items():
        print(f"  {k:8s}: {t[:, :8].tolist()}")
    if not (same_k and graphed and bits and cont and card_cpu
            and not chunked and n == want_n and worst <= MAMBA_REL):
        fail(f"19a jamba parity failed: launches {n} (want {want_n}), "
             f"Mamba block {layer}")

    rcfg = dataclasses.replace(get_config("rwkv6_3b"), n_layers=2,
                               dtype="float32", param_dtype="float32")
    rp = init_model(seed, rcfg)
    shapes = [(1024, 16), (1024, 12), (512, 16), (768, 10)]
    reqs = [Request(i, rng.integers(1, rcfg.vocab - 4, size=(m,)).astype(
        np.int32), k) for i, (m, k) in enumerate(shapes)]
    ceng = ContinuousEngine(rcfg, rp, slots=2, seg_len=4, max_len=1056)
    serve.reset_launch_counts()
    with _prefill_calls(ceng) as prefills:
        got = _run_clean(ceng, reqs)
    k7 = serve.launch_counts()["K7"]
    solo = Engine(rcfg, rp, max_len=1056)
    rcont = all(bool((got[r.rid] == solo.generate(
        r.prompt[None], r.n_new).tokens[0]).all()) for r in reqs)
    print(f"19a rwkv continuous: 2-layer full-width rwkv6_3b f32, "
          f"{len(reqs)} requests (prompts {[m for m, _ in shapes]}), 2 slots, "
          f"blocking: continuous == solo generate: {rcont}; {len(prefills)} "
          f"prefills, K7 {k7} (want {rcfg.n_layers} x {len(prefills)}); "
          f"{time.monotonic() - t0:.1f} s [{card}]", flush=True)
    if not rcont or ceng.chunked or k7 != rcfg.n_layers * len(prefills):
        fail(f"19a rwkv continuous failed: K7 {k7}, {len(prefills)} "
             f"prefills")
    del ceng, solo, rp
    torch.cuda.empty_cache()
    return {"layer": layer, "kernel_block": same_k, "graphed": graphed,
            "bits": bits, "continuous": cont, "card_cpu": card_cpu,
            "rwkv_continuous": rcont}


def jamba_slice(torch, seed: int, card: str) -> dict:
    """19b and 19c.  jamba_1_5_large at full width cut to JAMBA_LAYERS
    sub-blocks (four Mamba, MoE on the second and fourth, and the
    attention one; 24.1 B params), bf16 weights on a bf16 cache, random
    weights from the seed.  19b, the static slice through
    ``launch.serve`` (batch 4, prompt 4096, 32 new, dsa_mode "kernel"):
    K2 once a prefill, K1 once a step (one attention layer), a graph
    replay a step; then on one model: the share of (token, slot) pairs
    the capacity prefill dropped, the Mamba scans' share of a prefill
    (host clock, synchronised around each scan), a torch.profiler
    breakdown of the prefill and of a graphed decode step against the
    time to read the step's weights once.  19c, the continuous engine (4
    slots, dense cache, max_len 8192, blocking admission): 8 requests of
    1024-4096 tokens in whole 128-token blocks and 16-64 new, all queued
    at the start; every request ok, K2 once an admission, K1 once a
    decode step."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import cut_layers, get_config
    from repro_torch.inference.engine import Engine
    from repro_torch.inference.scheduler import (ContinuousEngine, Request,
                                                 summarize)
    from repro_torch.launch import serve
    from repro_torch.models import moe, ssm
    from repro_torch.models import transformer as TT
    from repro_torch.models.attention import RunFlags
    from repro_torch.tree import named_leaves
    t0 = time.monotonic()
    cfg = cut_layers(get_config("jamba_1_5_large"), JAMBA_LAYERS)
    b, plen, n_new = 4, 4096, 32
    max_len = plen + n_new + 16
    torch.cuda.reset_peak_memory_stats()
    serve.reset_launch_counts()
    res = serve.main(["--arch", "jamba_1_5_large", "--layers",
                      str(JAMBA_LAYERS), "--batch", str(b),
                      "--prompt-len", str(plen), "--new-tokens", str(n_new),
                      "--dsa", "--dsa-mode", "kernel", "--cache-dtype",
                      "bfloat16", "--seed", str(seed)])
    n = serve.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    row = serve.cache_bytes(TT.init_cache(
        cfg, 1, max_len, RunFlags(mode="decode", long_context=True),
        dtype=torch.bfloat16, device="meta"))
    out = {"prefill_ms": res.prefill_s * 1e3,
           "decode_tok_s": res.tokens_per_s, "peak_gib": peak,
           "cache_bytes_per_row": row,
           "launches": {k: v for k, v in n.items() if v}}
    tok = res.tokens
    print(f"19b jamba_1_5_large static slice ({JAMBA_LAYERS} layers bf16, "
          f"bf16 cache, batch {b}, prompt {plen}, {n_new} new, dsa_mode "
          f"kernel): prefill {res.prefill_s * 1e3:.1f} ms, decode "
          f"{res.tokens_per_s:.1f} tok/s over {res.decode_steps} steps "
          f"({res.decode_dispatches} graph replays), peak memory "
          f"{peak:.2f} GiB, cache {row} bytes per batch row, launches "
          + " ".join(f"{k} {v}" for k, v in n.items()) + f" [{card}]",
          flush=True)
    want = {"K2": 1, "K1": res.decode_steps}
    if (out["launches"] != want or res.decode_dispatches != res.decode_steps
            or tok.shape != (b, n_new) or tok.min() < 0
            or tok.max() >= cfg.vocab):
        fail(f"19b static slice: launches {n}, tokens {tok.shape}")
    del res
    gc.collect()
    torch.cuda.empty_cache()

    params = TT.init_model(seed, cfg)
    prompts = np.random.default_rng(seed).integers(
        1, cfg.vocab - 4, size=(b, plen)).astype(np.int32)
    eng = Engine(cfg, params, max_len=max_len, long_context=True,
                 dsa_mode="kernel", cache_dtype=torch.bfloat16)
    drops, scans = [], []
    dispatch, scan = moe._dispatch_positions, ssm._mamba_scan

    def counting(e_flat, num_experts, cap):
        pos = dispatch(e_flat, num_experts, cap)
        drops.append(((pos >= cap).sum(), pos.numel()))
        return pos

    def timed(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = scan(*a, **k)
        torch.cuda.synchronize()
        scans.append(time.perf_counter() - t)
        return r

    acts = [ProfilerActivity.CUDA]
    with torch.inference_mode():
        moe._dispatch_positions, ssm._mamba_scan = counting, timed
        try:
            _, _, scan_pf_s = eng.prefill(prompts)
        finally:
            moe._dispatch_positions, ssm._mamba_scan = dispatch, scan
        dropped = int(sum(int(d) for d, _ in drops))
        pairs = sum(p for _, p in drops)
        scan_s = sum(scans)
        _, _, prefill_s = eng.prefill(prompts)
        with profile(activities=acts) as prof:
            eng.prefill(prompts)
        pre = _device_time(prof, "jamba_prefill", 1)
        step = eng.scan_step(b)                                  # capture
        last, _, _ = eng.prefill(prompts, caches=eng.resident_cache(b))
        tok = last[:, -1].argmax(-1, keepdim=True)
        _, tok = _timed_decode(torch, step, tok, 2)              # warm
        step_ms, tok = _timed_decode(torch, step, tok, 8)
        with profile(activities=acts) as prof:
            _, tok = _timed_decode(torch, step, tok, 2)
        dec = _device_time(prof, "jamba_decode", 2)
    _print_profile(f"19b jamba_1_5_large prefill ({b} x {plen}) [{card}]",
                   prefill_s * 1e3, *pre)
    _print_profile(f"19b jamba_1_5_large decode step, graph replay (batch "
                   f"{b}) [{card}]", step_ms, *dec)
    # a decode step reads every weight once but the embedding table
    w_bytes = sum(p.numel() * p.element_size()
                  for k, p in named_leaves(params) if k != "/embed")
    bound_ms = w_bytes / HBM_BYTES_PER_S * 1e3
    out.update(dropped=dropped, pairs=pairs, prefill_busy_ms=pre[0],
               scan_s=scan_s, scan_prefill_s=scan_pf_s, step_ms=step_ms,
               step_busy_ms=dec[0], weight_bound_ms=bound_ms,
               capture_ms=step.capture_ms)
    print(f"19b: capacity prefill dropped {dropped} of {pairs} (token, "
          f"slot) pairs ({100 * dropped / pairs:.3f} %); the {len(scans)} "
          f"Mamba scans took {scan_s * 1e3:.1f} ms of a {scan_pf_s * 1e3:.1f}"
          f" ms prefill ({100 * scan_s / scan_pf_s:.1f} %, host clock, "
          f"synchronised around each scan); graphed decode step "
          f"{step_ms:.3f} ms (device busy {dec[0]:.3f} ms, capture "
          f"{step.capture_ms:.1f} ms) against {bound_ms:.3f} ms to read the "
          f"{w_bytes / 1e9:.2f} GB of weights once at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s ({100 * bound_ms / step_ms:.1f}"
          f" %) [{card}]", flush=True)
    del eng, step
    torch.cuda.empty_cache()

    rng = np.random.default_rng(seed + 1)
    reqs = [Request(i, rng.integers(1, cfg.vocab - 4, size=(128 * int(
        rng.integers(8, 33)),)).astype(np.int32),
        int(rng.integers(16, 65))) for i in range(8)]
    ceng = ContinuousEngine(cfg, params, slots=4, seg_len=16, max_len=8192,
                            long_context=True, dsa_mode="kernel",
                            cache_dtype=torch.bfloat16)
    serve.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with _prefill_calls(ceng) as prefills:
        results = ceng.serve(reqs)
    n = {k: v for k, v in serve.launch_counts().items() if v}
    st = ceng.stats
    summ = summarize(results, max(r.finish_s for r in results))
    cpeak = torch.cuda.max_memory_allocated() / 2**30
    print(f"19c jamba_1_5_large continuous slice (4 slots, dense cache, "
          f"max_len 8192, 8 requests, prompts "
          f"{min(len(r.prompt) for r in reqs)}-"
          f"{max(len(r.prompt) for r in reqs)}, blocking admission): "
          f"{summ['goodput_tok_s']} tok/s goodput, latency p50 "
          f"{summ['p50_latency_s']} s / p95 {summ['p95_latency_s']} s, TTFT "
          f"p50 {summ['p50_ttft_s']} s / p95 {summ['p95_ttft_s']} s, "
          f"{st['segments']} segments, {len(prefills)} prefills for "
          f"{st['admitted']} admissions, {st['decode_steps']} decode steps, "
          f"peak memory {cpeak:.2f} GiB, launches {n} [{card}]", flush=True)
    bad = [r.rid for r in results
           if r.status != "ok" or len(r.tokens) != r.n_new]
    want = {"K2": len(prefills), "K1": st["decode_steps"]}
    if len(results) != len(reqs) or bad or n != want or ceng.chunked:
        fail(f"19c continuous slice: bad {bad}, launches {n} (want {want})")
    out["continuous"] = {"summary": summ, "peak_gib": cpeak, "launches": n}
    del ceng, params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 19b-c: {time.monotonic() - t0:.1f} s", flush=True)
    return out


def rwkv_continuous_slice(torch, seed: int, card: str) -> dict:
    """19d.  rwkv6_3b at full width (32 layers, bf16 on a bf16 cache) in
    the continuous engine: 4 slots, max_len 8192, blocking admission, 8
    requests of 1024-4096 tokens in whole 32-token chunks (so K7 carries
    each prefill) and 16-64 new, all queued at the start; every request
    ok, K7 once a layer per prefill, no other kernel."""
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.inference.scheduler import (ContinuousEngine, Request,
                                                 summarize)
    from repro_torch.launch import serve
    from repro_torch.models.transformer import init_model
    t0 = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("rwkv6_3b")
    params = init_model(seed, cfg)
    rng = np.random.default_rng(seed + 2)
    reqs = [Request(i, rng.integers(1, cfg.vocab - 4, size=(32 * int(
        rng.integers(32, 129)),)).astype(np.int32),
        int(rng.integers(16, 65))) for i in range(8)]
    ceng = ContinuousEngine(cfg, params, slots=4, seg_len=16, max_len=8192,
                            cache_dtype=torch.bfloat16)
    serve.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with _prefill_calls(ceng) as prefills:
        results = ceng.serve(reqs)
    n = {k: v for k, v in serve.launch_counts().items() if v}
    st = ceng.stats
    summ = summarize(results, max(r.finish_s for r in results))
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"19d rwkv6_3b continuous slice (32 layers bf16, bf16 cache, 4 "
          f"slots, 8 requests, prompts {min(len(r.prompt) for r in reqs)}-"
          f"{max(len(r.prompt) for r in reqs)}, blocking admission): "
          f"{summ['goodput_tok_s']} tok/s goodput, latency p50 "
          f"{summ['p50_latency_s']} s / p95 {summ['p95_latency_s']} s, TTFT "
          f"p50 {summ['p50_ttft_s']} s / p95 {summ['p95_ttft_s']} s, "
          f"{st['segments']} segments, {len(prefills)} prefills, "
          f"{st['decode_steps']} decode steps, peak memory {peak:.2f} GiB, "
          f"launches {n} [{card}]", flush=True)
    bad = [r.rid for r in results
           if r.status != "ok" or len(r.tokens) != r.n_new]
    want = {"K7": cfg.n_layers * len(prefills)}
    if len(results) != len(reqs) or bad or n != want or ceng.chunked:
        fail(f"19d rwkv continuous: bad {bad}, launches {n} (want {want})")
    del ceng, params
    torch.cuda.empty_cache()
    print(f"phase 19d: {time.monotonic() - t0:.1f} s", flush=True)
    return {"summary": summ, "peak_gib": peak, "launches": n,
            "prefills": len(prefills)}


def jamba_train_slice(torch, seed: int, card: str) -> dict:
    """19e.  jamba_1_5_large at full width cut to its first sub-block (a
    Mamba block and a dense 24576-wide SwiGLU, 2.1 B params) through
    ``launch.train``: bf16 params with f32 moments, remat full, 4 steps of
    4 x 4096 tokens in 2 microbatches, each Mamba scan in 32 checkpointed
    128-token chunks; finite metrics, no kernel launched, mse 0 (no
    attention layer); the step time, tokens/s, the 6 N D share, peak
    memory, then one profiled step.  Then reduced jamba (one group of 8,
    f32): one train step (2 x 256, 2 microbatches, DSA block) on the card
    and on the CPU from the same params, gated as ``train_parity_phase``.
    (The MoE sub-blocks at full width train only across cards: ROADMAP
    Queue 1, "Distribution".)"""
    from repro_torch.configs.base import cut_layers, get_config, reduced
    from repro_torch.data.synthetic import DataConfig, lm_batches
    from repro_torch.launch import serve, train
    from repro_torch.optim import adamw
    from repro_torch.training import steps as ST
    from repro_torch.tree import named_leaves
    t0 = time.monotonic()
    cfg = cut_layers(get_config("jamba_1_5_large"), 1)
    b, s, steps, mb = 4, 4096, 4, 2
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    serve.reset_launch_counts()
    res = train.main(["--arch", "jamba_1_5_large", "--layers", "1",
                      "--steps", str(steps), "--seq", str(s), "--batch",
                      str(b), "--microbatches", str(mb), "--data", "lm",
                      "--log-interval", "1", "--seed", str(seed)])
    n = {k: v for k, v in serve.launch_counts().items() if v}
    peak = torch.cuda.max_memory_allocated() / 2**30
    rep = _train_report(torch, f"19e jamba_1_5_large train slice (1 layer: "
                        f"a Mamba block and a dense MLP, bf16, f32 moments, "
                        f"remat full) [{card}]", cfg, res.state,
                        res.metrics, res.step_s, b, s, mb, n, peak)
    opt = adamw.OptConfig(total_steps=steps + 2, warmup_steps=1)
    batch = next(lm_batches(DataConfig(vocab=cfg.vocab, seq_len=s,
                                       global_batch=b, seed=seed + 1)))
    wall, busy, kernels = _profiled_step(
        torch, f"19e jamba_1_5_large train step ({b} x {s}, {mb} "
        f"microbatches) [{card}]", ST.make_train_step(cfg, opt,
                                                      microbatches=mb),
        res.state, batch)
    mse = [m["mse"] for m in res.metrics]
    if any(mse) or len(res.step_s) != steps:
        fail(f"19e: mse {mse}, {len(res.step_s)} steps")
    del res
    torch.cuda.empty_cache()

    rcfg = reduced(get_config("jamba_1_5_large"))
    ropt = adamw.OptConfig(lr=1e-3, total_steps=10, warmup_steps=2)
    rbatch = next(lm_batches(DataConfig(vocab=rcfg.vocab, seq_len=256,
                                        global_batch=2, seed=seed)))
    cardst, _ = ST.init_train_state(seed, rcfg, ropt)
    cpu_params = to_cpu(cardst["params"])
    cpu = {"params": cpu_params, "opt": adamw.init(ropt, cpu_params),
           "step": 0}
    step = ST.make_train_step(rcfg, ropt, microbatches=2)
    serve.reset_launch_counts()
    cardst, m_card = step(cardst, rbatch)
    m_card = {k: float(v) for k, v in m_card.items()}
    n = {k: v for k, v in serve.launch_counts().items() if v}
    cpu, m_cpu = step(cpu, rbatch)
    m_cpu = {k: float(v) for k, v in m_cpu.items()}
    rel = {k: abs(m_card[k] - m_cpu[k]) / abs(m_cpu[k])
           for k in ("loss", "ce", "mse", "router_aux", "grad_norm")}
    lr = m_cpu["lr"]
    want = dict(named_leaves(cpu["params"]))
    worst, within, total = 0.0, 0, 0
    for path, p in named_leaves(cardst["params"]):
        d = (p.detach().cpu() - want[path].detach()).abs()
        worst = max(worst, float(d.max()))
        within += int((d <= 1e-5).sum())
        total += d.numel()
    print(f"19e jamba train parity: reduced jamba_1_5_large (8 sub-blocks) "
          f"f32, batch 2 x 256, 2 microbatches: card vs CPU relative "
          f"differences " + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
          + f" (rtol {TRAIN_METRIC_RTOL:g}); new params max |d| {worst:.3g} "
          f"(bound 2 lr = {2 * lr:.3g}), {100 * within / total:.3f} % within "
          f"1e-5; kernels launched: {n or 'none'}; "
          f"{time.monotonic() - t0:.1f} s [{card}]", flush=True)
    if (n or worst > 2 * lr or within < TRAIN_PARAM_SHARE * total
            or max(rel.values()) > TRAIN_METRIC_RTOL):
        fail("19e reduced jamba training parity (card vs CPU) failed")
    del cardst, cpu
    torch.cuda.empty_cache()
    print(f"phase 19e: {time.monotonic() - t0:.1f} s", flush=True)
    return dict(rep, busy_share=busy / wall, kernels=kernels, rel=rel)


XATTN_GATE = 0.5              # every cross gate xgate in phase 20 (init: 0)
XATTN_REL = 1e-4
VISION_LAYERS = 5             # 20a and 20d: one group, cross-attention at 3


def _xattn_cfg(arch: str, layers: int, f32: bool):
    """``arch`` at full width cut to ``layers`` decoder layers (whisper's
    encoder to as many), f32 if asked."""
    from repro_torch.configs.base import cut_layers, get_config
    cfg = cut_layers(get_config(arch), layers)
    if cfg.enc_dec:
        cfg = dataclasses.replace(cfg, n_enc_layers=layers)
    if f32:
        cfg = dataclasses.replace(cfg, dtype="float32",
                                  param_dtype="float32")
    return cfg


@contextlib.contextmanager
def _token_topk(M, masks: list, flips=None):
    """Within it the model's token top-k (``M.row_topk_mask``: the DSA
    token path, which whisper's 1500-frame encoder takes) appends each
    mask it returns to ``masks``; or, with ``flips`` a list, returns the
    masks recorded before, in order, in place of its own, and appends to
    ``flips`` the count of rows where its own selection differs.  So the
    CPU replays the card's selection and the comparison stays continuous:
    a predicted score a last bit apart moves a row's top-k."""
    own = M.row_topk_mask
    replay = None if flips is None else iter(list(masks))

    def topk(scores, keep, valid=None):
        mine = own(scores, keep, valid)
        if replay is None:
            masks.append(mine)
            return mine
        theirs = next(replay).to(mine.device)
        flips.append(int((theirs != mine).any(-1).sum()))
        return theirs

    M.row_topk_mask = topk
    try:
        yield
    finally:
        M.row_topk_mask = own


def xattn_parity_phase(torch, seed: int, card: str) -> dict:
    """20a.  whisper_small at full width with 2 encoder and 2 decoder
    layers (1500 frames, prompts of 384) and llama_3_2_vision cut to one
    group of 5 (prompts of 1024, 1601 image tokens), both f32 with the
    gates at 0.5, batch 2, 16 new tokens, DSA long-context decode: the
    kernel path gives the block path's greedy tokens (K2 once a decoder
    layer a prefill, none in whisper's 1500-frame encoder, which takes
    the token fallback; K1 once a decoder layer a step), the graphed scan
    loop the eager python loop's (one capture), ``_graph_bits`` holds
    (the cross ``ck``/``cv`` included); the continuous engine (blocking,
    no encoder or image input at admission) gives each request its solo
    tokens; the CPU gives the card's tokens and prefill logits (within
    XATTN_REL of the largest magnitude) at batch 1 on the kernel path,
    prompts of 384 and 256, whisper's encoder over 1024 of its frames
    (a block multiple: its block path and K2 non-causal) and over all
    1500 (the main path's: the token fallback).  The token top-k is
    discontinuous (with DSA off the encoder cannot run 1500 frames at
    all: the reference's dense path needs a multiple of 256 above 1024
    queries, ROADMAP Queue 3): a predicted score a last bit apart (the
    card's and the CPU's products round differently) moves a row's
    selection, so at 1500 frames the CPU replays the card's selection
    (``_token_topk``) and the rows where its own would differ are
    printed.
    Then reduced whisper's encoder (64 frames, block 16) on the card: K2
    non-causal once a layer, its output == the block path's within 1e-5
    of the largest magnitude."""
    import numpy as np
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.core import masks as M
    from repro_torch.inference.engine import Engine
    from repro_torch.inference.scheduler import ContinuousEngine, Request
    from repro_torch.launch import serve
    from repro_torch.models import transformer as TT
    from repro_torch.models.attention import RunFlags
    from repro_torch.tree import map_tree
    t0 = time.monotonic()
    out = {}
    for arch, layers, plen, cpu_len, cpu_frames, shapes in (
            ("whisper_small", 2, 384, 384, (1024, 1500),
             [(384, 12), (384, 9), (256, 12), (200, 8)]),
            ("llama_3_2_vision", VISION_LAYERS, 1024, 256, (0,),
             [(1024, 12), (700, 9), (1024, 12), (512, 8)])):
        cfg = _xattn_cfg(arch, layers, f32=True)
        params = TT.set_cross_gates(TT.init_model(seed, cfg), XATTN_GATE)
        rng = np.random.default_rng(seed)
        b, n_new = 2, 16
        prompts = rng.integers(1, cfg.vocab - 4, size=(b, plen)).astype(
            np.int32)
        ex = serve.draw_extras(cfg, b, rng)
        kw = dict(max_len=plen + n_new + 16, long_context=True)
        toks, n, captures, steps = {}, {}, 0, 0
        for name, extra in (("block", dict(dsa_mode="block")),
                            ("kernel", dict(dsa_mode="kernel")),
                            ("eager", dict(dsa_mode="kernel",
                                           loop="python"))):
            serve.reset_launch_counts()
            eng = Engine(cfg, params, **kw, **extra)
            res = eng.generate(prompts, n_new, extras=ex)
            toks[name] = res.tokens
            n[name] = {k: v for k, v in serve.launch_counts().items() if v}
            if name == "kernel":
                captures, steps = eng.graphs.captures, res.decode_steps
            del eng
        nl = cfg.n_layers
        want_n = {"block": {}, "kernel": {"K2": nl, "K1": nl * steps},
                  "eager": {"K2": nl, "K1": nl * (n_new - 1)}}
        same_k = bool((toks["kernel"] == toks["block"]).all())
        graphed = (bool((toks["kernel"] == toks["eager"]).all())
                   and captures == 1)
        bits = _graph_bits(torch, Engine(cfg, params, dsa_mode="kernel",
                                         **kw), prompts, extras=ex)
        reqs = [Request(i, rng.integers(1, cfg.vocab - 4, size=(m,)).astype(
            np.int32), k) for i, (m, k) in enumerate(shapes)]
        ceng = ContinuousEngine(cfg, params, slots=2, seg_len=4,
                                dsa_mode="kernel", **kw)
        got = _run_clean(ceng, reqs)
        solo = Engine(cfg, params, dsa_mode="kernel", **kw)
        cont = all(bool((got[r.rid] == solo.generate(
            r.prompt[None], r.n_new).tokens[0]).all()) for r in reqs)
        chunked = ceng.chunked
        del ceng, solo
        cpu_params = map_tree(lambda t: t.cpu(), params)
        vs_cpu = {}
        for frames in cpu_frames:
            c = (dataclasses.replace(cfg, enc_seq_len=frames) if frames
                 else cfg)
            one = {k: v[:1, :frames or None] for k, v in ex.items()}
            got, sel, flips = {}, [], []
            for dev, p in (("card", params), ("cpu", cpu_params)):
                e = Engine(c, p, device="cpu" if dev == "cpu" else None,
                           dsa_mode="kernel", **kw)
                with _token_topk(M, sel, flips if dev == "cpu" else None):
                    last, _, _ = e.prefill(prompts[:1, :cpu_len],
                                           extras=one)
                    got[dev] = (last.cpu(), e.generate(
                        prompts[:1, :cpu_len], 4, extras=one).tokens)
                del e
            rel = float((got["card"][0] - got["cpu"][0]).abs().max()) / \
                float(got["cpu"][0].abs().max())
            vs_cpu[frames] = {
                "tokens_equal": bool((got["card"][1] == got["cpu"][1]).all()),
                "rel": rel, "imposed": len(sel), "replayed": len(flips),
                "flips": flips}
        card_cpu = all(v["tokens_equal"] and v["rel"] <= XATTN_REL
                       and v["replayed"] == v["imposed"]
                       for v in vs_cpu.values())
        del params, cpu_params
        gc.collect()
        torch.cuda.empty_cache()
        print(f"20a {arch} parity: full width, {nl} decoder layers"
              + (f" and {cfg.n_enc_layers} encoder layers over "
                 f"{cfg.enc_seq_len} frames" if cfg.enc_dec else
                 f", {cfg.n_image_tokens} image tokens")
              + f", f32, gates {XATTN_GATE}, prompt {plen}, {n_new} new: "
              f"kernel == block: {same_k} (launches {n}); graphed scan == "
              f"eager python loop: {graphed} ({captures} capture); graphed "
              f"step == eager step bit for bit (logits, every cache leaf "
              f"and ck/cv, 4 steps): {bits}; continuous (blocking, "
              f"chunked {chunked}, {len(reqs)} requests, no cross input at "
              f"admission) == solo generate: {cont}; card vs CPU (batch 1, "
              f"prompt {cpu_len}, 4 new, kernel path; limit {XATTN_REL:g}): "
              + "; ".join((f"{f} frames: " if f else "")
                          + f"tokens equal {v['tokens_equal']}, prefill "
                          f"logits {v['rel']:.2e} of the largest magnitude"
                          + (f" under the card's token top-k ({v['imposed']} "
                             f"masks imposed on the CPU, {v['replayed']} "
                             f"replayed; the CPU's own differs in "
                             f"{v['flips']} of {f} rows)"
                             if v["imposed"] else "")
                          for f, v in vs_cpu.items())
              + f"; {time.monotonic() - t0:.1f} s [{card}]", flush=True)
        for k, t in toks.items():
            print(f"  {k:8s}: {t[:, :8].tolist()}")
        if not (same_k and graphed and bits and cont and card_cpu
                and not chunked and n == want_n):
            fail(f"20a {arch} parity failed: launches {n} (want {want_n})")
        out[arch] = {"kernel_block": same_k, "graphed": graphed,
                     "bits": bits, "continuous": cont, "card_cpu": vs_cpu,
                     "launches": n}

    rcfg = reduced(get_config("whisper_small"))
    rp = TT.init_model(seed, rcfg)
    enc_x = torch.from_numpy(serve.draw_extras(
        rcfg, 2, np.random.default_rng(seed))["enc_x"]).cuda()
    encs, k2 = {}, {}
    with torch.inference_mode():
        for mode in ("block", "kernel"):
            serve.reset_launch_counts()
            encs[mode], _ = TT._encode(rp, rcfg, RunFlags(
                mode="prefill", dsa_mode=mode), enc_x)
            torch.cuda.synchronize()
            k2[mode] = serve.launch_counts()["K2"]
    erel = float((encs["kernel"] - encs["block"]).abs().max()) / float(
        encs["block"].abs().max())
    print(f"20a reduced whisper encoder ({rcfg.n_enc_layers} layers, "
          f"{rcfg.enc_seq_len} frames, block {rcfg.dsa.block_q}, f32): K2 "
          f"non-causal {k2['kernel']} (block path {k2['block']}), kernel vs "
          f"block {erel:.2e} of the largest magnitude (limit 1e-5); "
          f"{time.monotonic() - t0:.1f} s [{card}]", flush=True)
    if k2 != {"block": 0, "kernel": rcfg.n_enc_layers} or erel > 1e-5:
        fail(f"20a reduced encoder: K2 {k2}, kernel vs block {erel}")
    out["encoder"] = {"k2": k2["kernel"], "rel": erel}
    print(f"phase 20a: {time.monotonic() - t0:.1f} s", flush=True)
    return out


def _cross_prefill_profile(torch, label: str, eng, prompts, extras,
                           card: str) -> dict:
    """A warm prefill's ms and a torch.profiler breakdown of another;
    then the graphed decode step's ms (8 steps after 2 warm ones) and
    its breakdown over 2 more."""
    from torch.profiler import ProfilerActivity, profile
    b = prompts.shape[0]
    acts = [ProfilerActivity.CUDA]
    step = eng.scan_step(b)                                      # capture
    with torch.inference_mode():
        eng.prefill(prompts, extras=extras)
        _, _, prefill_s = eng.prefill(prompts, extras=extras)
        with profile(activities=acts) as prof:
            eng.prefill(prompts, extras=extras)
        pre = _device_time(prof, "xattn_prefill", 1)
        last, _, _ = eng.prefill(prompts, caches=eng.resident_cache(b),
                                 extras=extras)
        tok = last[:, -1].argmax(-1, keepdim=True)
        _, tok = _timed_decode(torch, step, tok, 2)               # warm
        step_ms, tok = _timed_decode(torch, step, tok, 8)
        with profile(activities=acts) as prof:
            _, tok = _timed_decode(torch, step, tok, 2)
        dec = _device_time(prof, "xattn_decode", 2)
    _print_profile(f"{label} prefill ({b} x {prompts.shape[1]}) [{card}]",
                   prefill_s * 1e3, *pre)
    _print_profile(f"{label} decode step, graph replay (batch {b}) "
                   f"[{card}]", step_ms, *dec)
    return {"prefill_ms": prefill_s * 1e3, "prefill_busy_ms": pre[0],
            "prefill_kernels": pre[1], "step_ms": step_ms,
            "step_busy_ms": dec[0], "capture_ms": step.capture_ms}


def whisper_slice(torch, seed: int, card: str) -> dict:
    """20b.  whisper_small at full size (12 encoder and 12 decoder
    layers, 0.34 B params), bf16 weights on a bf16 cache, through
    ``launch.serve`` (batch 4, 1500 frames from the seed, prompt 384 and
    64 new: the decoder's 448-token context; DSA kernel path): K2 once a
    decoder layer a prefill (the 1500-frame encoder takes the token
    fallback), K1 once a decoder layer a step, a graph replay a step.
    Then on one model with the gates at 0.5: the encoder's ms alone, a
    profiled prefill and graphed decode step."""
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.inference.engine import Engine
    from repro_torch.launch import serve
    from repro_torch.models import transformer as TT
    from repro_torch.models.attention import RunFlags
    t0 = time.monotonic()
    cfg = get_config("whisper_small")
    b, plen, n_new, max_len = 4, 384, 64, 448
    torch.cuda.reset_peak_memory_stats()
    serve.reset_launch_counts()
    res = serve.main(["--arch", "whisper_small", "--batch", str(b),
                      "--prompt-len", str(plen), "--new-tokens", str(n_new),
                      "--max-len", str(max_len), "--dsa", "--dsa-mode",
                      "kernel", "--cache-dtype", "bfloat16", "--seed",
                      str(seed)])
    n = {k: v for k, v in serve.launch_counts().items() if v}
    peak = torch.cuda.max_memory_allocated() / 2**30
    tok = res.tokens
    print(f"20b whisper_small static slice (12 + 12 layers bf16, bf16 "
          f"cache, batch {b}, {cfg.enc_seq_len} frames, prompt {plen}, "
          f"{n_new} new, dsa_mode kernel): prefill "
          f"{res.prefill_s * 1e3:.1f} ms (encoder included), decode "
          f"{res.tokens_per_s:.1f} tok/s over {res.decode_steps} steps "
          f"({res.decode_dispatches} graph replays), peak memory "
          f"{peak:.2f} GiB, launches {n} [{card}]", flush=True)
    want = {"K2": cfg.n_layers, "K1": cfg.n_layers * res.decode_steps}
    if (n != want or res.decode_dispatches != res.decode_steps
            or tok.shape != (b, n_new) or tok.min() < 0
            or tok.max() >= cfg.vocab):
        fail(f"20b whisper static slice: launches {n} (want {want}), "
             f"tokens {tok.shape}")
    out = {"prefill_ms": res.prefill_s * 1e3,
           "decode_tok_s": res.tokens_per_s, "peak_gib": peak,
           "launches": n}
    del res
    gc.collect()
    torch.cuda.empty_cache()
    params = TT.set_cross_gates(TT.init_model(seed, cfg), XATTN_GATE)
    rng = np.random.default_rng(seed)
    prompts = rng.integers(1, cfg.vocab - 4, size=(b, plen)).astype(np.int32)
    ex = serve.draw_extras(cfg, b, rng)
    eng = Engine(cfg, params, max_len=max_len, long_context=True,
                 dsa_mode="kernel", cache_dtype=torch.bfloat16)
    enc_x = torch.from_numpy(ex["enc_x"]).cuda().to(torch.bfloat16)
    flags = RunFlags(mode="prefill", dsa_mode="kernel")
    with torch.inference_mode():
        TT._encode(params, cfg, flags, enc_x)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(3):
            TT._encode(params, cfg, flags, enc_x)
        torch.cuda.synchronize()
        enc_ms = (time.perf_counter() - t) / 3 * 1e3
    prof = _cross_prefill_profile(torch, "20b whisper_small", eng, prompts,
                                  ex, card)
    out.update(prof, encoder_ms=enc_ms)
    print(f"20b whisper_small: encoder {enc_ms:.2f} ms of a "
          f"{prof['prefill_ms']:.2f} ms prefill (batch {b}, "
          f"{cfg.enc_seq_len} frames, host clock, synchronised); graphed "
          f"decode step {prof['step_ms']:.3f} ms (device busy "
          f"{prof['step_busy_ms']:.3f} ms, capture {prof['capture_ms']:.1f} "
          f"ms); {time.monotonic() - t0:.1f} s [{card}]", flush=True)
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 20b: {time.monotonic() - t0:.1f} s", flush=True)
    return out


def vision_slice(torch, seed: int, card: str) -> dict:
    """20c.  llama_3_2_vision at full depth (40 layers, 10.4 B params,
    ~20.7 GB of bf16 weights) on a bf16 cache through ``launch.serve``
    (batch 4, prompt 4096, 1601 image tokens from the seed, 32 new, DSA
    kernel path): K2 once a layer a prefill, K1 once a layer a step.
    Then on one model with the gates at 0.5: a profiled prefill and
    graphed decode step against the time to read every weight but the
    embedding once; then the continuous engine (4 slots, dense cache,
    max_len 8192, blocking, bucketed, no images) on 8 requests of
    1024-4096 tokens and 16-64 new, all queued at the start: every
    request ok, K2 40 an admission prefill, K1 40 a decode step."""
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.inference.engine import Engine
    from repro_torch.inference.scheduler import (ContinuousEngine, Request,
                                                 summarize)
    from repro_torch.launch import serve
    from repro_torch.models import transformer as TT
    from repro_torch.tree import named_leaves
    t0 = time.monotonic()
    cfg = get_config("llama_3_2_vision")
    b, plen, n_new = 4, 4096, 32
    torch.cuda.reset_peak_memory_stats()
    serve.reset_launch_counts()
    res = serve.main(["--arch", "llama_3_2_vision", "--batch", str(b),
                      "--prompt-len", str(plen), "--new-tokens", str(n_new),
                      "--dsa", "--dsa-mode", "kernel", "--cache-dtype",
                      "bfloat16", "--seed", str(seed)])
    n = {k: v for k, v in serve.launch_counts().items() if v}
    peak = torch.cuda.max_memory_allocated() / 2**30
    tok = res.tokens
    print(f"20c llama_3_2_vision static slice (40 layers bf16, bf16 cache, "
          f"batch {b}, prompt {plen}, {cfg.n_image_tokens} image tokens, "
          f"{n_new} new, dsa_mode kernel): prefill "
          f"{res.prefill_s * 1e3:.1f} ms, decode {res.tokens_per_s:.1f} "
          f"tok/s over {res.decode_steps} steps ({res.decode_dispatches} "
          f"graph replays), peak memory {peak:.2f} GiB, launches {n} "
          f"[{card}]", flush=True)
    want = {"K2": cfg.n_layers, "K1": cfg.n_layers * res.decode_steps}
    if (n != want or res.decode_dispatches != res.decode_steps
            or tok.shape != (b, n_new) or tok.min() < 0
            or tok.max() >= cfg.vocab):
        fail(f"20c vision static slice: launches {n} (want {want}), "
             f"tokens {tok.shape}")
    out = {"prefill_ms": res.prefill_s * 1e3,
           "decode_tok_s": res.tokens_per_s, "peak_gib": peak,
           "launches": n}
    del res
    gc.collect()
    torch.cuda.empty_cache()
    params = TT.set_cross_gates(TT.init_model(seed, cfg), XATTN_GATE)
    rng = np.random.default_rng(seed)
    prompts = rng.integers(1, cfg.vocab - 4, size=(b, plen)).astype(np.int32)
    ex = serve.draw_extras(cfg, b, rng)
    eng = Engine(cfg, params, max_len=plen + n_new + 16, long_context=True,
                 dsa_mode="kernel", cache_dtype=torch.bfloat16)
    prof = _cross_prefill_profile(torch, "20c llama_3_2_vision", eng,
                                  prompts, ex, card)
    w_bytes = sum(p.numel() * p.element_size()
                  for k, p in named_leaves(params) if k != "/embed")
    bound_ms = w_bytes / HBM_BYTES_PER_S * 1e3
    out.update(prof, weight_bound_ms=bound_ms)
    print(f"20c llama_3_2_vision: graphed decode step {prof['step_ms']:.3f}"
          f" ms (device busy {prof['step_busy_ms']:.3f} ms, capture "
          f"{prof['capture_ms']:.1f} ms) against {bound_ms:.3f} ms to read "
          f"the {w_bytes / 1e9:.2f} GB of weights once at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s "
          f"({100 * bound_ms / prof['step_ms']:.1f} %) [{card}]", flush=True)
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    rng = np.random.default_rng(seed + 1)
    reqs = [Request(i, rng.integers(1, cfg.vocab - 4, size=(128 * int(
        rng.integers(8, 33)),)).astype(np.int32),
        int(rng.integers(16, 65))) for i in range(8)]
    ceng = ContinuousEngine(cfg, params, slots=4, seg_len=16, max_len=8192,
                            long_context=True, dsa_mode="kernel",
                            cache_dtype=torch.bfloat16)
    serve.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with _prefill_calls(ceng) as prefills:
        results = ceng.serve(reqs)
    n = {k: v for k, v in serve.launch_counts().items() if v}
    st = ceng.stats
    summ = summarize(results, max(r.finish_s for r in results))
    cpeak = torch.cuda.max_memory_allocated() / 2**30
    print(f"20c llama_3_2_vision continuous slice (4 slots, dense cache, "
          f"max_len 8192, 8 requests, prompts "
          f"{min(len(r.prompt) for r in reqs)}-"
          f"{max(len(r.prompt) for r in reqs)}, blocking admission, no "
          f"image): {summ['goodput_tok_s']} tok/s goodput, latency p50 "
          f"{summ['p50_latency_s']} s / p95 {summ['p95_latency_s']} s, TTFT "
          f"p50 {summ['p50_ttft_s']} s / p95 {summ['p95_ttft_s']} s, "
          f"{st['segments']} segments, {len(prefills)} prefills for "
          f"{st['admitted']} admissions, {st['decode_steps']} decode steps, "
          f"peak memory {cpeak:.2f} GiB, launches {n} [{card}]", flush=True)
    bad = [r.rid for r in results
           if r.status != "ok" or len(r.tokens) != r.n_new]
    want = {"K2": cfg.n_layers * len(prefills),
            "K1": cfg.n_layers * st["decode_steps"]}
    if len(results) != len(reqs) or bad or n != want or ceng.chunked:
        fail(f"20c continuous slice: bad {bad}, launches {n} (want {want})")
    out["continuous"] = {"summary": summ, "peak_gib": cpeak, "launches": n}
    del ceng, params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 20c: {time.monotonic() - t0:.1f} s", flush=True)
    return out


def xattn_train_slice(torch, seed: int, card: str) -> dict:
    """20d.  Training with the second input (``launch.train`` feeds tokens
    only, as the reference's does, so these go through
    ``steps.make_train_step``): whisper_small whole (12 + 12 layers, bf16,
    f32 moments, remat full), 3 steps of 4 x 448 tokens with 1500-frame
    ``enc_x``; llama_3_2_vision cut to one group of 5 (2.1 B params), 3
    steps of 4 x 4096 with 1601-token ``img`` in 2 microbatches; the gates
    at 0.5; each with the step time, tokens/s, the 6 N D share over the
    tree's parameters (the encoder's and the cross sub-layers' included,
    which the reference's ``num_params`` leaves out), peak memory and a
    profiled step.  Then reduced whisper_small (f32, ``enc_x`` of 64
    frames): one train step (2 x 64, 2 microbatches, DSA block) on the
    card and on the CPU from the same params, gated as
    ``train_parity_phase``."""
    import numpy as np
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.data.synthetic import DataConfig, lm_batches
    from repro_torch.launch import serve
    from repro_torch.models import transformer as TT
    from repro_torch.optim import adamw
    from repro_torch.training import steps as ST
    from repro_torch.tree import named_leaves
    t0 = time.monotonic()
    out = {}
    for arch, cfg, s, mb in (
            ("whisper_small", get_config("whisper_small"), 448, 1),
            ("llama_3_2_vision", _xattn_cfg("llama_3_2_vision",
                                             VISION_LAYERS, f32=False),
             4096, 2)):
        b, steps = 4, 3
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        opt = adamw.OptConfig(total_steps=steps + 2, warmup_steps=1)
        state, _ = ST.init_train_state(seed, cfg, opt)
        TT.set_cross_gates(state["params"], XATTN_GATE)
        rng = np.random.default_rng(seed)
        data = lm_batches(DataConfig(vocab=cfg.vocab, seq_len=s,
                                     global_batch=b, seed=seed))
        step = ST.make_train_step(cfg, opt, microbatches=mb)
        serve.reset_launch_counts()
        metrics, step_s = [], []
        for _ in range(steps):
            batch = dict(next(data), **serve.draw_extras(cfg, b, rng))
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
            step_s.append(time.perf_counter() - t)
        n = {k: v for k, v in serve.launch_counts().items() if v}
        peak = torch.cuda.max_memory_allocated() / 2**30
        rep = _train_report(torch, f"20d {arch} train slice "
                            f"({cfg.n_layers} decoder layers"
                            + (f" + {cfg.n_enc_layers} encoder layers"
                               if cfg.enc_dec else "")
                            + f", bf16, f32 moments, remat full, with "
                            f"{'enc_x' if cfg.enc_dec else 'img'}) [{card}]",
                            cfg, state, metrics, step_s, b, s, mb, n, peak)
        batch = dict(next(data), **serve.draw_extras(cfg, b, rng))
        wall, busy, kernels = _profiled_step(
            torch, f"20d {arch} train step ({b} x {s}, {mb} microbatches) "
            f"[{card}]", step, state, batch)
        out[arch] = dict(rep, busy_share=busy / wall, kernels=kernels,
                         profiled_ms=wall)
        del state, step, batch
    gc.collect()
    torch.cuda.empty_cache()

    rcfg = reduced(get_config("whisper_small"))
    ropt = adamw.OptConfig(lr=1e-3, total_steps=10, warmup_steps=2)
    rbatch = dict(next(lm_batches(DataConfig(vocab=rcfg.vocab, seq_len=64,
                                             global_batch=2, seed=seed))),
                  **serve.draw_extras(rcfg, 2, np.random.default_rng(seed)))
    cardst, _ = ST.init_train_state(seed, rcfg, ropt)
    TT.set_cross_gates(cardst["params"], XATTN_GATE)
    cpu_params = to_cpu(cardst["params"])
    cpu = {"params": cpu_params, "opt": adamw.init(ropt, cpu_params),
           "step": 0}
    step = ST.make_train_step(rcfg, ropt, microbatches=2)
    serve.reset_launch_counts()
    cardst, m_card = step(cardst, rbatch)
    m_card = {k: float(v) for k, v in m_card.items()}
    n = {k: v for k, v in serve.launch_counts().items() if v}
    cpu, m_cpu = step(cpu, rbatch)
    m_cpu = {k: float(v) for k, v in m_cpu.items()}
    rel = {k: abs(m_card[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-30)
           for k in ("loss", "ce", "mse", "grad_norm")}
    lr = m_cpu["lr"]
    want = dict(named_leaves(cpu["params"]))
    worst, within, total = 0.0, 0, 0
    for path, p in named_leaves(cardst["params"]):
        d = (p.detach().cpu() - want[path].detach()).abs()
        worst = max(worst, float(d.max()))
        within += int((d <= 1e-5).sum())
        total += d.numel()
    print(f"20d whisper train parity: reduced whisper_small f32 with enc_x, "
          f"batch 2 x 64, 2 microbatches: card vs CPU relative differences "
          + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
          + f" (rtol {TRAIN_METRIC_RTOL:g}); new params max |d| {worst:.3g} "
          f"(bound 2 lr = {2 * lr:.3g}), {100 * within / total:.3f} % within "
          f"1e-5; kernels launched: {n or 'none'}; "
          f"{time.monotonic() - t0:.1f} s [{card}]", flush=True)
    if (n or worst > 2 * lr or within < TRAIN_PARAM_SHARE * total
            or max(rel.values()) > TRAIN_METRIC_RTOL):
        fail("20d reduced whisper training parity (card vs CPU) failed")
    out["parity"] = rel
    del cardst, cpu
    torch.cuda.empty_cache()
    print(f"phase 20d: {time.monotonic() - t0:.1f} s", flush=True)
    return out


def static_slice(torch, seed: int, arch: str, dsa_mode: str, want,
                 prompt_len: int = 4096, quant=None) -> dict:
    """Serve ``arch`` at full width through ``repro_torch.launch.serve``:
    all layers in bf16, batch 4, ``prompt_len`` tokens, 64 new (32 with
    ``quant``: an fp8 K/V cache and int8 selection), DSA on ``dsa_mode``
    (an arch without DSA falls back to off).  ``want(n_layers, steps)``
    gives the launches each kernel must show; every other kernel must
    show none."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve
    from repro_torch.models.attention import RunFlags
    from repro_torch.models.transformer import init_cache
    cfg = get_config(arch)
    n_new = 32 if quant else 64
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30
    serve.reset_launch_counts()
    res = serve.main(["--arch", arch, "--batch", "4", "--prompt-len",
                      str(prompt_len), "--new-tokens", str(n_new), "--dsa",
                      "--dsa-mode", dsa_mode, "--seed", str(seed)]
                     + (["--kv-quant", quant, "--select-dtype", "int8"]
                        if quant else []))
    n = serve.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    dsa = cfg.dsa.enabled
    flags = RunFlags(mode="decode", long_context=dsa,
                     kv_quant=quant if dsa else None,
                     select_dtype="int8" if quant and dsa else "float32")
    row = serve.cache_bytes(init_cache(cfg, 1, prompt_len + n_new + 16,
                                       flags, dtype=torch.float32,
                                       device="meta"))
    label = (f"{arch} {dsa_mode if dsa else 'no DSA'}"
             + (f", {quant} K/V, int8 selection" if quant else ""))
    print(f"slice ({label}): prefill {res.prefill_s * 1e3:.1f} ms, decode "
          f"{res.tokens_per_s:.1f} tok/s over {res.decode_steps} steps, "
          f"peak memory {peak:.2f} GiB ({held:.2f} held at its start), "
          f"cache {row} bytes per batch row, launches "
          + " ".join(f"{k} {v}" for k, v in n.items()))
    expect = want(cfg.n_layers, res.decode_steps)
    bad = {k: v for k, v in n.items() if v != expect.get(k, 0)}
    if bad:
        fail(f"the slice ({label}) launched {bad}, expected {expect}")
    if res.decode_dispatches != res.decode_steps:
        fail(f"{res.decode_dispatches} graph replays for "
             f"{res.decode_steps} decode steps")
    tok = res.tokens
    if tok.shape != (4, n_new) or tok.min() < 0 or tok.max() >= cfg.vocab:
        fail(f"bad tokens: shape {tok.shape}, range {tok.min()}..{tok.max()}")
    return {"prefill_ms": res.prefill_s * 1e3,
            "decode_tok_s": res.tokens_per_s, "decode_s": res.decode_s,
            "decode_steps": res.decode_steps, "peak_gib": peak,
            "cache_bytes_per_row": row, "launches": n}


# -- phase 21: distributed serving (dp x tp) -----------------------------------
#
# The card is one: tp 2 and dp 2 run as two processes on it over gloo
# (launch.mesh.run_spmd; gloo stages CUDA tensors through the host and
# cannot be captured, so those engines decode eagerly), and the NCCL path
# runs at world size 1 on a ("data", "model") mesh of (1, 1).  Each rank
# function below runs in a spawned process and returns what the phase
# prints and gates.

# 21b's prediction, written before its first run: the tp-2 prefill's
# last-row logits against the unsharded run's, max |gap| over max |logit|
# (bf16: each rank rounds its partial product to bf16 and the gloo sum
# rounds again, ~2^-8 a projection, over 8 layers).  The first run
# showed that it holds only where no block selection runs: on the kernel
# path the predictor's 4-bit fake quant turns those last bits into other
# selected blocks (0.895 there at 4 x 4096, PERF.md §6), so the gate compares
# the prefill with DSA off and the kernel path's gap is printed
TP_LOGIT_TOL = 5e-2

# 21a's gate of the kernel path under tp at the main path's selection
# geometry (4 x 4096, 32 key blocks a row): in f32 the tp sums differ
# from the unsharded products in the last f32 bits, too few to flip a
# block, so the last-row logits agree to max |gap| / max |logit| <= 1e-4
TP_F32_LOGIT_TOL = 1e-4


def _yi_cut(layers: int, f32: bool):
    from repro_torch.configs.base import cut_layers, get_config
    cfg = cut_layers(get_config("yi_6b"), layers)
    if f32:
        cfg = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    return cfg


def _collectives_line(counts: dict) -> str:
    return ", ".join(f"{op} {n}" for op, n in counts.items())


def _p21a_rank(rank: int, seed: int) -> dict:
    """21a on one rank: 2-layer full-width yi_6b f32, kernel DSA.  The
    static engine at tp 2 and at dp 2, greedy and sampled (4 x 512, 16
    new), then the continuous engine at tp 2, chunked and then paged with
    int8 K/V (6 requests, 4 slots), each against the unsharded engine
    (graphed) on the same card; each run's kernel launches and
    collectives on this rank.  Last, the tp-2 prefill's last-row logits
    at 4 x 4096 (32 key blocks a row, the main path's selection) against
    the unsharded prefill's (``TP_F32_LOGIT_TOL``)."""
    import numpy as np
    import torch
    from repro_torch.distributed import collectives as C
    from repro_torch.inference.engine import Engine
    from repro_torch.inference.scheduler import ContinuousEngine, Request
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models.transformer import init_model
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _yi_cut(2, f32=True)
    params = init_model(seed, cfg)
    kw = dict(long_context=True, dsa_mode="kernel")
    rng = np.random.default_rng(seed)
    prompts = rng.integers(1, cfg.vocab - 4, size=(4, 512)).astype(np.int32)
    plain = Engine(cfg, params, max_len=640, **kw)
    meshes = {"tp 2": make_serving_mesh(dp=1, tp=2, cfg=cfg),
              "dp 2": make_serving_mesh()}
    out = {}
    for name, mesh in meshes.items():
        eng = Engine(cfg, params, max_len=640, mesh=mesh, **kw)
        for greedy in (True, False):
            want = plain.generate(prompts, 16, greedy=greedy,
                                  seed=seed).tokens
            serve.reset_launch_counts()
            before = C.snapshot()
            res = eng.generate(prompts, 16, greedy=greedy, seed=seed)
            out[name, greedy] = dict(
                equal=bool((res.tokens == want).all()),
                launches=serve.launch_counts(), steps=res.decode_steps,
                model=C.count_collectives(before, "model"),
                data=C.count_collectives(before, "data"),
                graphs=eng.graphs is not None)
        del eng

    def reqs():
        r = np.random.default_rng(seed + 1)
        return [Request(i, r.integers(1, cfg.vocab - 4, size=(n,)).astype(
            np.int32), k, seed=i) for i, (n, k) in enumerate(
            [(700, 12), (300, 16), (512, 8), (640, 10), (256, 14),
             (480, 9)])]

    ckw = dict(slots=4, max_len=1024, seg_len=8, chunk_tokens=256, **kw)
    for name, extra in (("chunked", {}),
                        ("paged int8", dict(paged=True, kv_quant="int8",
                                            select_dtype="int8"))):
        p = ContinuousEngine(cfg, params, **ckw, **extra)
        want = p.run(reqs())
        del p
        s = ContinuousEngine(cfg, params, mesh=meshes["tp 2"], **ckw,
                             **extra)
        serve.reset_launch_counts()
        got = s.run(reqs())
        out[name] = dict(
            equal=set(got) == set(want) and all(
                bool((got[r] == want[r]).all()) for r in want),
            launches=serve.launch_counts(), chunks=s.stats["chunks"],
            steps=s.stats["decode_steps"])
        del s
    # the kernel path at the main path's selection geometry, 4 x 4096
    big = dict(kw, max_len=4096 + 16)
    long = rng.integers(1, cfg.vocab - 4, size=(4, 4096)).astype(np.int32)
    last = {}
    for name, mesh in (("tp 2", meshes["tp 2"]), ("plain", None)):
        eng = Engine(cfg, params, mesh=mesh, **big)
        last[name] = eng.prefill(long, caches=eng.resident_cache(4))[0] \
            .float().cpu()
        del eng
    got, want = last["tp 2"], last["plain"]
    out["4k"] = dict(gap=float((got - want).abs().max()),
                     scale=float(want.abs().max()),
                     first_equal=bool((got.argmax(-1)
                                       == want.argmax(-1)).all()))
    return out


def _p21b_rank(rank: int, seed: int) -> dict:
    """21b on one rank: full-width yi_6b cut to 8 layers, bf16 on the
    default f32 cache, kernel DSA, at tp 2.  The engine draws the weights
    itself (``init_model`` with its ``place``) and keeps this rank's
    shard of each piece: the peak memory of the process up to then is
    the placement's.  Then the prefill's last-row logits (4 x 4096),
    ``generate`` (32 new) timed, the launches and the serving peak.  Rank
    0 then serves the same prompts unsharded at the same depth (the same
    weights: the card's generator from the same seed) for the logit gap
    and the greedy agreement."""
    import functools
    import numpy as np
    import torch
    from repro_torch.distributed.sharding import tree_bytes
    from repro_torch.inference.engine import Engine
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models.transformer import init_model
    cfg = _yi_cut(8, f32=False)
    kw = dict(max_len=4096 + 32 + 16, long_context=True, dsa_mode="kernel")
    prompts = np.random.default_rng(seed).integers(
        1, cfg.vocab - 4, size=(4, 4096)).astype(np.int32)
    eng = Engine(cfg, functools.partial(init_model, seed, cfg),
                 mesh=make_serving_mesh(dp=1, tp=2, cfg=cfg), **kw)
    place_peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    last = {m: eng.prefill(prompts, caches=eng.resident_cache(4),
                           dsa_mode=m)[0].float().cpu()
            for m in ("off", "kernel")}
    serve.reset_launch_counts()
    res = eng.generate(prompts, 32)
    out = dict(shard=eng.weight_bytes_per_device(), place_peak=place_peak,
               prefill_ms=res.prefill_s * 1e3, tok_s=res.tokens_per_s,
               steps=res.decode_steps, launches=serve.launch_counts(),
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               graphs=eng.graphs is not None)
    del eng
    torch.cuda.empty_cache()
    if rank == 0:
        params = init_model(seed, cfg)
        out["whole"] = tree_bytes(params)
        # the largest leaf, which its draw holds in f32 beside its cast
        out["leaf"] = max(t.numel() for t in (
            params["embed"], params["lm_head"]))
        plain = Engine(cfg, params, **kw)
        del params
        for m, got in last.items():
            want = plain.prefill(prompts, caches=plain.resident_cache(4),
                                 dsa_mode=m)[0].float().cpu()
            out["gap", m] = float((got - want).abs().max())
            out["scale", m] = float(want.abs().max())
            out["first_equal", m] = bool((got.argmax(-1)
                                          == want.argmax(-1)).all())
        ref = plain.generate(prompts, 32)
        out["agree"] = float((res.tokens == ref.tokens).mean())
        out["plain_prefill_ms"] = ref.prefill_s * 1e3
        out["plain_tok_s"] = ref.tokens_per_s
    return out


# 21c's and 22c's depth (it was 8): NCCL at world size 1 is held to
# mesh=None bit for bit, layer by layer alike, so depth adds time only
NCCL1_LAYERS = 2


def _p21c_rank(rank: int, seed: int) -> dict:
    """21c: NCCL at world size 1 on a ("data", "model") mesh of (1, 1),
    full-width yi_6b cut to ``NCCL1_LAYERS`` (bf16, kernel DSA, 4 x 1024): the
    sharded code path with every collective.  Its decode graph captures
    them; graphed == eager bit for bit (``_graph_bits``), tokens ==
    ``mesh=None``, the counters of a generate against (steps + 1) x the
    budget, and the NCCL kernels of 4 graph replays in a profiler
    trace."""
    import numpy as np
    import torch
    from repro_torch.distributed import collectives as C
    from repro_torch.inference.engine import Engine
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.transformer import init_model
    cfg = _yi_cut(NCCL1_LAYERS, f32=False)
    kw = dict(max_len=1024 + 16 + 16, long_context=True, dsa_mode="kernel")
    prompts = np.random.default_rng(seed).integers(
        1, cfg.vocab - 4, size=(4, 1024)).astype(np.int32)
    params = init_model(seed, cfg)
    eng = Engine(cfg, params, mesh=make_host_mesh(model=1), **kw)
    out = dict(bits=_graph_bits(torch, eng, prompts))
    before = C.snapshot()
    res = eng.generate(prompts, 16)
    out["model"] = C.count_collectives(before, "model")
    out["data"] = C.count_collectives(before, "data")
    out["steps"] = res.decode_steps
    out["captured"] = eng.graphs is not None and eng.graphs.captures
    want = Engine(cfg, params, **kw).generate(prompts, 16)
    out["equal"] = bool((res.tokens == want.tokens).all())
    step = eng.scan_step(4)
    tok = torch.as_tensor(res.tokens[:, -1:], device="cuda").long()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(4):
            step(tok)
        torch.cuda.synchronize()
    out["kernels"] = C.kernel_collectives(prof)
    out["n_layers"] = cfg.n_layers
    return out


def distributed_phase(torch, seed: int) -> dict:
    """Phase 21, distributed serving: 21a (two gloo processes on the card,
    2-layer f32: tp 2, dp 2 and the continuous engine at tp 2, each ==
    ``mesh=None``, launches and collectives per rank), 21b (tp 2 at full
    width in bf16, 8 layers: prefill ms, decode tok/s, the logit gap
    against ``TP_LOGIT_TOL``, the greedy agreement, weight bytes per
    device, each rank's peak memory) and 21c (NCCL at world size 1:
    graphed == eager, tokens, the collective budget by counters and by
    the profiler).  Returns 21b's rank-0 launches (the yi tp-2 kernel
    rows)."""
    from repro_torch.launch.mesh import run_spmd
    t0 = time.monotonic()
    store = tempfile.mkdtemp()
    gloo = dict(store_dir=store, backend="gloo", device_ids=[0, 0],
                timeout_s=300, args=(seed,))
    try:
        a = run_spmd(_p21a_rank, 2, **gloo)
        ta = time.monotonic()
        b = run_spmd(_p21b_rank, 2, **gloo)
        tb = time.monotonic()
        c = run_spmd(_p21c_rank, 1, store_dir=store, backend="nccl",
                     device_ids=[0], timeout_s=300, args=(seed,))[0]
    finally:
        shutil.rmtree(store, ignore_errors=True)
    budget = 2 * 2 + 1
    bad = []
    for key in [k for k in a[0] if isinstance(k, tuple)]:
        name, greedy = key
        for r, res in enumerate(a):
            x = res[key]
            n = {k: v for k, v in x["launches"].items() if v}
            print(f"21a {name} static {'greedy' if greedy else 'sampled'}, "
                  f"rank {r}: == mesh=None {x['equal']}, {x['steps']} "
                  f"steps ({'graphed' if x['graphs'] else 'eager'}), "
                  f"launches {n}, collectives model "
                  f"[{_collectives_line(x['model'])}] data "
                  f"[{_collectives_line(x['data'])}]", flush=True)
            want = ({"all-reduce": budget * (x["steps"] + 1),
                     "all-gather": x["steps"] + 1} if name == "tp 2"
                    else {"all-reduce": 0, "all-gather": 0})
            if (not x["equal"] or x["model"] != want
                    or n != {"K2": 2, "K1": 2 * x["steps"]}):
                bad.append(f"21a {name} greedy={greedy} rank {r}")
    for name in ("chunked", "paged int8"):
        for r, res in enumerate(a):
            x = res[name]
            n = {k: v for k, v in x["launches"].items() if v}
            print(f"21a continuous tp 2 {name}, rank {r}: == mesh=None "
                  f"{x['equal']}, {x['chunks']} chunk steps, {x['steps']} "
                  f"decode steps, launches {n}", flush=True)
            k3, k4 = (("K3q", "K4q") if name == "paged int8"
                      else ("K3", "K1"))
            if not x["equal"] or not n.get(k3) or not n.get(k4):
                bad.append(f"21a continuous {name} rank {r}")
    for r, res in enumerate(a):
        x = res["4k"]
        rel4k = x["gap"] / max(x["scale"], 1e-30)
        print(f"21a tp 2 prefill 4 x 4096 f32, kernel DSA, rank {r}: "
              f"last-row logits max |gap| {x['gap']:.4g} of max |logit| "
              f"{x['scale']:.4g} = {rel4k:.3g} (gated: <= "
              f"{TP_F32_LOGIT_TOL:g}), first tokens equal "
              f"{x['first_equal']}", flush=True)
        if not rel4k <= TP_F32_LOGIT_TOL:
            bad.append(f"21a 4 x 4096 logit gap rank {r} {rel4k:.3g}")
    print(f"phase 21a: {ta - t0:.1f} s", flush=True)
    r0 = b[0]
    rel = {m: r0["gap", m] / max(r0["scale", m], 1e-30)
           for m in ("off", "kernel")}
    print(f"21b yi_6b 8 layers bf16, tp 2 over gloo on one card, 4 x 4096, "
          f"32 new, kernel DSA: prefill {r0['prefill_ms']:.1f} ms "
          f"(unsharded {r0['plain_prefill_ms']:.1f}), decode "
          f"{r0['tok_s']:.1f} tok/s over {r0['steps']} eager steps "
          f"(unsharded graphed {r0['plain_tok_s']:.1f}), greedy agreement "
          f"{r0['agree']:.3f}", flush=True)
    for m in ("off", "kernel"):
        print(f"  last-row logits, DSA {m}: max |gap| {r0['gap', m]:.4g} of "
              f"max |logit| {r0['scale', m]:.4g} = {rel[m]:.3g}"
              + (f" (gated: <= {TP_LOGIT_TOL:g})" if m == "off" else
                 " (printed: other selected blocks)")
              + f", first tokens equal {r0['first_equal', m]}", flush=True)
    whole = r0["whole"]
    for r, x in enumerate(b):
        n = {k: v for k, v in x["launches"].items() if v}
        # placing: the shards drawn so far, the last leaf (lm_head) whole
        # in bf16 and in f32 while it is drawn
        bound = x["shard"] + r0["leaf"] * (2 + 4)
        print(f"  rank {r}: weight bytes {x['shard']} of {whole} "
              f"replicated ({x['shard'] / whole:.4f}); peak memory placing "
              f"the weights {x['place_peak'] / 2**30:.2f} GiB (the whole "
              f"tree {whole / 2**30:.2f} GiB, shard + the largest leaf's "
              f"draw {bound / 2**30:.2f} GiB), serving "
              f"{x['peak_gib']:.2f} GiB; launches {n}", flush=True)
        if (x["shard"] > 0.5 * whole + 0.08 * whole
                or not x["place_peak"] < whole
                or n != {"K2": 8, "K1": 8 * x["steps"]}):
            bad.append(f"21b rank {r}")
    if rel["off"] > TP_LOGIT_TOL:
        bad.append(f"21b logit gap (DSA off) {rel['off']:.3g} > "
                   f"{TP_LOGIT_TOL}")
    print(f"phase 21b: {tb - ta:.1f} s", flush=True)
    want = {"all-reduce": (2 * c["n_layers"] + 1) * (c["steps"] + 1),
            "all-gather": c["steps"] + 1}
    kern = {op: n / 4 for op, n in c["kernels"].items()}
    print(f"21c NCCL world 1, mesh (data 1, model 1), yi_6b "
          f"{c['n_layers']} layers bf16, "
          f"4 x 1024: graphed == eager bit for bit {c['bits']} "
          f"({c['captured']} graphs captured), tokens == mesh=None "
          f"{c['equal']}; collectives over {c['steps']} steps + the prefill: "
          f"model [{_collectives_line(c['model'])}] (budget "
          f"[{_collectives_line(want)}]), data "
          f"[{_collectives_line(c['data'])}]; NCCL kernels a graph replay "
          f"(profiler): {kern} against 2 x {c['n_layers']} + 1 all-reduces "
          f"and 1 all-gather", flush=True)
    if not (c["bits"] and c["equal"] and c["captured"]) or \
            c["model"] != want or any(c["data"].values()):
        bad.append("21c")
    print(f"phase 21c: {time.monotonic() - tb:.1f} s", flush=True)
    print(f"phase 21: {time.monotonic() - t0:.1f} s", flush=True)
    if bad:
        fail(f"phase 21: {bad}")
    return {"launches": b[0]["launches"]}


# -- phase 22: sharded training -------------------------------------------------

# 22a's gates, f32.  Predicted before the first run: the sharded losses
# within ~1e-6 of the unsharded run on the card, gated at 1e-4.  Measured
# (first run): so with DSA off, but 1.4e-4 on the block path, where the
# unsharded model computing its rows in two halves gives the FSDP run's
# loss bit for bit: the 4-bit predictor turns the products' last bits
# (which follow their shapes) into other levels.  So DSA off is gated at
# SHARD_F32_RTOL, and on the block path FSDP's first loss against the
# unsharded model on each rank's rows (SHARD_ROWS_RTOL); the block-path
# gaps against the whole-batch run are printed
SHARD_F32_RTOL = 1e-4
SHARD_ROWS_RTOL = 1e-6
# 22b's prediction, printed: the bf16 loss gap of FSDP 2 against 16d's
# unsharded run, relative (the gradients' bf16 reduce-scatter and the
# half-batch products round otherwise; the predictor's selection may move)
SHARD_BF16_PRED = 2e-2
SHARD_SEQ, SHARD_BATCH, SHARD_STEPS = 512, 4, 3


def _p22_opt(steps: int, moment_dtype: str = "float32"):
    from repro_torch.optim import adamw
    return adamw.OptConfig(moment_dtype=moment_dtype, total_steps=steps + 1,
                           warmup_steps=1)


def _p22_batches(vocab: int, seq: int, batch: int, n: int, seed: int):
    from repro_torch.data.synthetic import DataConfig, lm_batches
    data = lm_batches(DataConfig(vocab=vocab, seq_len=seq,
                                 global_batch=batch, seed=seed))
    return [next(data) for _ in range(n)]


def _p22a_plain(cfg, opt, flags, bs, seed: int) -> dict:
    """22a's unsharded run on this rank's card: each step's loss, and the
    first step's loss of the same model computed on the batch's two
    halves of rows (FSDP 2's rows), averaged."""
    import torch
    from repro_torch.training import steps as ST
    state, _ = ST.init_train_state(seed, cfg, opt)
    dev = state["params"]["embed"].device
    with torch.no_grad():
        halves = [float(ST.loss_fn(state["params"], cfg, flags, ST._on(
            {k: v[i:i + 2] for k, v in bs[0].items()}, dev))[0])
            for i in (0, 2)]
    step = ST.make_train_step(cfg, opt, flags)
    losses = [float(step(state, b)[1]["loss"]) for b in bs]
    del state, step
    torch.cuda.empty_cache()
    return dict(losses=losses, halves=sum(halves) / 2)


def _p22_rank(rank: int, seed: int) -> dict:
    """22a and 22b on one rank of two gloo processes sharing the card."""
    import statistics
    import torch
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.sharding import make_rules, tree_bytes
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.attention import RunFlags
    from repro_torch.models.transformer import init_model
    from repro_torch.training import steps as ST
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    cfg = _yi_cut(2, f32=True)
    opt = _p22_opt(SHARD_STEPS)
    bs = _p22_batches(cfg.vocab, SHARD_SEQ, SHARD_BATCH, SHARD_STEPS, seed)
    meta = init_model(0, cfg, device="meta")
    out["whole"] = tree_bytes(meta)
    for mode in ("block", "off"):
        flags = RunFlags(mode="train", dsa_mode=mode)
        if rank == 0:           # the ranks share the card: one runs it
            out[mode, "plain"] = _p22a_plain(cfg, opt, flags, bs, seed)
        for name, model, rules in (("FSDP 2", 1, make_rules(tp=False)),
                                   ("TP 2 + SP", 2, make_rules())):
            t0 = time.monotonic()
            mesh = make_host_mesh(model=model)
            state, _ = ST.init_train_state(seed, cfg, opt, mesh=mesh,
                                           rules=rules)
            step = ST.make_train_step(cfg, opt, flags, mesh=mesh,
                                      rules=rules)
            before = C.snapshot()
            losses = [float(step(state, b)[1]["loss"]) for b in bs]
            out[mode, name] = dict(
                losses=losses, counts=C.count_by_axis(before),
                budget=step.plan.collective_budget(
                    1, seq_len=SHARD_SEQ, remat=cfg.remat,
                    mse=mode != "off", steps=SHARD_STEPS),
                params=tree_bytes(state["params"]),
                moments=tree_bytes(state["opt"]["m"])
                + tree_bytes(state["opt"]["v"]),
                s=time.monotonic() - t0)
            del state, step
            torch.cuda.empty_cache()
    # 22b: 16d's run under make_rules() on (2, 1), FSDP over the two ranks
    cfg = _yi_cut(YI_TRAIN_LAYERS, f32=False)
    opt = _p22_opt(4, "bfloat16")
    mesh = make_host_mesh(model=1)
    torch.cuda.reset_peak_memory_stats()
    state, _ = ST.init_train_state(seed, cfg, opt, mesh=mesh,
                                   rules=make_rules())
    step = ST.make_train_step(cfg, opt, microbatches=2, mesh=mesh,
                              rules=make_rules())
    bs = _p22_batches(cfg.vocab, 4096, 4, 3, seed)
    losses, step_s = [], []
    for b in bs:
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses.append(float(step(state, b)[1]["loss"]))
        step_s.append(time.perf_counter() - t)
    whole = tree_bytes(init_model(0, cfg, device="meta"))
    out["22b"] = dict(
        losses=losses, step_s=step_s,
        median_ms=statistics.median(step_s[1:]) * 1e3,
        state=tree_bytes(state["params"]) * 2 + tree_bytes(state["opt"]["m"])
        + tree_bytes(state["opt"]["v"]),
        whole=whole * 2 + 2 * whole,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    del state, step
    torch.cuda.empty_cache()
    return out


def _p22c_rank(rank: int, seed: int) -> dict:
    """22c: NCCL at world size 1 on a (1, 1) mesh under ``make_rules()``,
    yi_6b at ``NCCL1_LAYERS`` in bf16 (bf16 moments), 2 steps of 2 x 512 in 2
    microbatches, deterministic algorithms, against ``mesh=None`` in the
    same process; then one profiled sharded step's NCCL kernels."""
    import os
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.training import steps as ST
    from repro_torch.tree import named_leaves
    torch.use_deterministic_algorithms(True, warn_only=True)
    cfg = _yi_cut(NCCL1_LAYERS, f32=False)
    opt = _p22_opt(3, "bfloat16")
    bs = _p22_batches(cfg.vocab, 512, 2, 3, seed)
    mesh = make_host_mesh(model=1)
    runs, secs = {}, {}
    for name, m in (("plain", None), ("mesh", mesh)):
        t0 = time.monotonic()
        rules = None if m is None else make_rules()
        state, _ = ST.init_train_state(seed, cfg, opt, mesh=m, rules=rules)
        step = ST.make_train_step(cfg, opt, microbatches=2, mesh=m,
                                  rules=rules)
        torch.cuda.synchronize()
        t1 = time.monotonic()
        before = C.snapshot()
        metrics = [{k: float(v) for k, v in step(state, b)[1].items()}
                   for b in bs[:2]]
        counts = C.count_by_axis(before)
        secs[name] = (t1 - t0, time.monotonic() - t1)
        runs[name] = dict(metrics=metrics, counts=counts, params={
            p: t.detach().clone() for p, t in named_leaves(state["params"])})
        if m is not None:
            runs[name]["budget"] = step.plan.collective_budget(
                2, seq_len=512, remat=cfg.remat, mse=True, steps=2)
            t2 = time.monotonic()
            acts = [torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                step(state, bs[2])
                torch.cuda.synchronize()
            runs[name]["kernels"] = C.kernel_collectives(prof)
            secs["profile"] = time.monotonic() - t2
        del state, step
        torch.cuda.empty_cache()
    plain, got = runs["plain"], runs["mesh"]
    first = None
    gaps = {}
    for p, t in got["params"].items():
        d = (t.float() - plain["params"][p].float()).abs()
        gaps[p] = (float(d.max()), int((d > 0).sum()), d.numel())
        if first is None and gaps[p][1]:
            first = p
    return dict(metrics=(plain["metrics"], got["metrics"]),
                counts=got["counts"], budget=got["budget"],
                kernels=got["kernels"], first=first,
                gaps={p: g for p, g in gaps.items() if g[1]},
                bitwise=first is None
                and plain["metrics"] == got["metrics"], secs=secs)


def distributed_train_phase(torch, seed: int, yi16d: dict) -> dict:
    """Phase 22, sharded training: 22a (two gloo processes on the card,
    2-layer f32, block DSA and DSA off: FSDP 2 and TP 2 + SP against the
    unsharded run on each rank, the gates of ``SHARD_F32_RTOL`` and
    ``SHARD_ROWS_RTOL``, the collectives against the budget; bytes a
    rank), 22b (FSDP 2 at 4 layers in bf16, 16d's run: step ms, state
    bytes a rank, peak memory, the loss gaps against 16d's printed beside
    their prediction), 22c (NCCL at world size 1: bit for bit against
    ``mesh=None`` or the first departing leaf, the budget, the NCCL
    kernels)."""
    import math
    from repro_torch.distributed import collectives as C
    from repro_torch.launch.mesh import run_spmd
    t0 = time.monotonic()
    store = tempfile.mkdtemp()
    try:
        ab = run_spmd(_p22_rank, 2, store_dir=store, backend="gloo",
                      device_ids=[0, 0], timeout_s=400, args=(seed,))
        tab = time.monotonic()
        c = run_spmd(_p22c_rank, 1, store_dir=store, backend="nccl",
                     device_ids=[0], timeout_s=300, args=(seed,))[0]
    finally:
        shutil.rmtree(store, ignore_errors=True)
    bad = []

    def budget_ok(x):
        try:
            C.check_train_collectives(x["counts"], x["budget"])
            return True
        except AssertionError as e:
            print(f"  {e}", flush=True)
            return False

    whole = ab[0]["whole"]
    for mode in ("block", "off"):
        plain = ab[0][mode, "plain"]
        print(f"22a unsharded yi_6b 2 layers f32, DSA {mode} (rank 0): "
              f"{SHARD_STEPS} steps of {SHARD_BATCH} x {SHARD_SEQ}, losses "
              + ", ".join(f"{v:.6f}" for v in plain["losses"])
              + f"; first loss on the two halves of the rows "
              f"{plain['halves']:.6f}", flush=True)
        for r, res in enumerate(ab):
            for name in ("FSDP 2", "TP 2 + SP"):
                x = res[mode, name]
                rel = [abs(a - b) / abs(b) for a, b in zip(
                    x["losses"], plain["losses"])]
                rows = abs(x["losses"][0] - plain["halves"]) / abs(
                    plain["halves"])
                gate = (f"gated: <= {SHARD_F32_RTOL:g}" if mode == "off"
                        else "printed: the predictor's levels")
                ok = budget_ok(x)
                print(f"  {name}, rank {r} ({x['s']:.1f} s): losses "
                      + ", ".join(f"{v:.6f}" for v in x["losses"])
                      + "; gap / loss " + ", ".join(f"{v:.3g}" for v in rel)
                      + f" ({gate})"
                      + (f"; first loss against the halves {rows:.3g} "
                         f"(gated: <= {SHARD_ROWS_RTOL:g})"
                         if mode == "block" and name == "FSDP 2" else "")
                      + "; collectives " + ", ".join(
                          f"{op} {a} {n}" for (op, a), n in sorted(
                              x["counts"].items()))
                      + f" == budget {ok}"
                      + (f"; bytes params {x['params']} of {whole} "
                         f"({x['params'] / whole:.4f}), grads the params' "
                         f"shapes, moments {x['moments']} of {2 * whole} "
                         f"({x['moments'] / whole / 2:.4f})"
                         if mode == "block" else ""), flush=True)
                if not ok:
                    bad.append(f"22a {mode} {name} rank {r} budget")
                if mode == "off" and max(rel) > SHARD_F32_RTOL:
                    bad.append(f"22a off {name} rank {r} {max(rel):.3g}")
                if (mode == "block" and name == "FSDP 2"
                        and rows > SHARD_ROWS_RTOL):
                    bad.append(f"22a block FSDP 2 rank {r} rows {rows:.3g}")
    ref = yi16d["losses"][:3]
    for r, res in enumerate(ab):
        x = res["22b"]
        rel = [abs(a - b) / abs(b) for a, b in zip(x["losses"], ref)]
        print(f"22b yi_6b {YI_TRAIN_LAYERS} layers bf16, FSDP 2 over gloo on "
              f"one card "
              f"(make_rules() on (2, 1)), 4 x 4096 in 2 microbatches, rank "
              f"{r}: step ms " + ", ".join(f"{t * 1e3:.1f}"
                                           for t in x["step_s"])
              + f" (median of steps 2-3 {x['median_ms']:.1f}; 16d "
              f"unsharded {yi16d['step_ms']:.1f}); state bytes "
              f"{x['state']} of {x['whole']} replicated "
              f"({x['state'] / x['whole']:.4f}, predicted ~0.5); peak "
              f"{x['peak_gib']:.2f} GiB; losses "
              + ", ".join(f"{v:.4f}" for v in x["losses"])
              + " against 16d's " + ", ".join(f"{v:.4f}" for v in ref)
              + ": gap / loss " + ", ".join(f"{v:.3g}" for v in rel)
              + f" (predicted <= {SHARD_BF16_PRED:g}; printed)",
              flush=True)
        if not all(map(math.isfinite, x["losses"])):
            bad.append(f"22b rank {r}: a loss is not finite")
    print(f"phase 22a-b: {tab - t0:.1f} s", flush=True)
    ok = budget_ok(c)
    (pm, gm) = c["metrics"]
    print(f"22c NCCL world 1, (1, 1) mesh under make_rules(), yi_6b "
          f"{NCCL1_LAYERS} layers bf16, 2 steps of 2 x 512 in 2 "
          f"microbatches: losses "
          + ", ".join(f"{m['loss']:.6f}" for m in gm) + " (mesh=None "
          + ", ".join(f"{m['loss']:.6f}" for m in pm) + "); bit for bit "
          f"(metrics and every updated param) {c['bitwise']}"
          + ("" if c["bitwise"] else
             f"; first departing leaf {c['first']}: "
             + "; ".join(f"{p} max |gap| {g[0]:.3g} on {g[1]} of {g[2]}"
                         for p, g in list(c["gaps"].items())[:4]))
          + "; collectives " + ", ".join(
              f"{op} {a} {n}" for (op, a), n in sorted(c["counts"].items()))
          + f" == budget {ok}; NCCL kernels in one profiled step "
          f"{c['kernels']}; s (init, 2 steps): mesh=None "
          f"{c['secs']['plain'][0]:.1f}, {c['secs']['plain'][1]:.1f}; "
          f"sharded {c['secs']['mesh'][0]:.1f}, {c['secs']['mesh'][1]:.1f}; "
          f"profiled step {c['secs']['profile']:.1f}", flush=True)
    if not ok:
        bad.append("22c budget")
    print(f"phase 22c: {time.monotonic() - tab:.1f} s", flush=True)
    print(f"phase 22: {time.monotonic() - t0:.1f} s", flush=True)
    if bad:
        fail(f"phase 22: {bad}")
    return {"22b": ab[0]["22b"], "22c": c}


# -- phase 23: expert-parallel MoE training ------------------------------------

# 23a's gate, f32, DSA off (22a's reason: the predictor's 4-bit levels turn
# the products' last bits into other blocks), no pair dropped (capacity
# factor E / top_k), the router term off: EP's losses against the
# unsharded run's.  Predicted before the first run: within ~1e-6
EP_F32_RTOL = 1e-4
EP_SEQ, EP_BATCH, EP_STEPS = 512, 4, 3
# 23b's predictions, printed: a call moves E cap d 2
# bytes, ~126 MB at 4096 tokens a rank and capacity factor 1.25; six calls
# a layer a microbatch (two forward, two backward, two in the recompute)
# at ~1.4 GB/s through the LANES gloo groups
EP_STEP_PRED_MS = (2000.0, 6000.0)
EP_STATE_PRED = (0.50, 0.52)


def _mixtral_cut(layers: int, f32: bool, cf=None, aux=None):
    from repro_torch.configs.base import cut_layers, get_config
    cfg = cut_layers(get_config("mixtral_8x22b"), layers)
    mo = cfg.moe
    if cf is not None:
        mo = dataclasses.replace(mo, capacity_factor=cf)
    if aux is not None:
        mo = dataclasses.replace(mo, router_aux_weight=aux)
    cfg = dataclasses.replace(cfg, moe=mo)
    if f32:
        cfg = dataclasses.replace(cfg, dtype="float32",
                                  param_dtype="float32")
    return cfg


def _p23_rank(rank: int, seed: int) -> dict:
    """23a and 23b on one rank of two gloo processes sharing the card,
    mixtral_8x22b at full width on (1, 2) under ``make_rules()``: EP 2 x
    TP 2 + SP."""
    import statistics
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.sharding import make_rules, tree_bytes
    from repro_torch.launch import train as LT
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    from repro_torch.models.attention import RunFlags
    from repro_torch.models.transformer import init_model
    from repro_torch.training import steps as ST
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    # 23a: 1 layer f32, DSA off, no drops, the router term off
    e = 8
    cfg = _mixtral_cut(1, f32=True, cf=e / 2, aux=0.0)
    opt = _p22_opt(EP_STEPS)
    flags = RunFlags(mode="train", dsa_mode="off")
    bs = _p22_batches(cfg.vocab, EP_SEQ, EP_BATCH, EP_STEPS, seed)
    out["whole"] = tree_bytes(init_model(0, cfg, device="meta"))
    t0 = time.monotonic()
    if rank == 0:           # alone on the card: the other rank waits
        state, _ = ST.init_train_state(seed, cfg, opt)
        step = ST.make_train_step(cfg, opt, flags)
        out["plain"] = [float(step(state, b)[1]["loss"]) for b in bs]
        del state, step
        torch.cuda.empty_cache()
    dist.barrier()
    out["plain_s"] = time.monotonic() - t0
    t0 = time.monotonic()
    mesh = make_host_mesh(model=2)
    rules = make_rules()
    state, _ = ST.init_train_state(seed, cfg, opt, mesh=mesh, rules=rules)
    step = ST.make_train_step(cfg, opt, flags, mesh=mesh, rules=rules)
    before = C.snapshot()
    losses = [float(step(state, b)[1]["loss"]) for b in bs]
    out["23a"] = dict(
        losses=losses, counts=C.count_by_axis(before),
        budget=step.plan.collective_budget(
            1, seq_len=EP_SEQ, remat=cfg.remat, mse=False, steps=EP_STEPS),
        ep=step.plan.ep_active(EP_SEQ),
        params=tree_bytes(state["params"]),
        moments=tree_bytes(state["opt"]["m"]) + tree_bytes(state["opt"]["v"]),
        s=time.monotonic() - t0)
    del state, step
    torch.cuda.empty_cache()
    # 23b: launch.train's run at 2 layers bf16 with bf16 moments, the
    # config's capacity factor and router term, 4 x 4096 in 2 microbatches
    t0 = time.monotonic()
    layers, b, s, mb, steps = 2, 4, 4096, 2, 3
    cfg = _mixtral_cut(layers, f32=False)
    torch.cuda.reset_peak_memory_stats()
    moe.ep_drops(reset=True)
    before = C.snapshot()
    res = LT.train(LT.parse_args([
        "--arch", "mixtral_8x22b", "--layers", str(layers), "--steps",
        str(steps), "--seq", str(s), "--batch", str(b),
        "--microbatches", str(mb), "--moment-dtype", "bfloat16",
        "--data", "lm", "--log-interval", "100", "--seed", str(seed)]),
        mesh, rules)
    counts = C.count_by_axis(before)
    dropped, pairs = moe.ep_drops()
    plan = ST.make_train_step(cfg, opt, mesh=mesh, rules=rules).plan
    cap = moe.ep_cap(cfg, b // mb, plan.batch_ranks, s, 2)
    st = res.state
    out["23b"] = dict(
        layers=layers, losses=[m["loss"] for m in res.metrics],
        router=[m["router_aux"] for m in res.metrics],
        step_s=res.step_s, median_ms=statistics.median(res.step_s[1:]) * 1e3,
        dropped=dropped, pairs=pairs, cap=cap,
        call_bytes=e * cap * cfg.d_model * 2,
        calls=counts.get(("all-to-all", "model"), 0) // steps,
        budget_calls=plan.collective_budget(
            mb, seq_len=s, remat=cfg.remat, mse=True).get(
                ("all-to-all", "model"), 0),
        state=tree_bytes(st["params"]) * 2 + tree_bytes(st["opt"]["m"])
        + tree_bytes(st["opt"]["v"]),
        whole=tree_bytes(init_model(0, cfg, device="meta")) * 4,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        s=time.monotonic() - t0)
    del res, st
    torch.cuda.empty_cache()
    return out


def ep_train_phase(torch, seed: int, mix17c: dict) -> dict:
    """Phase 23, expert-parallel MoE training: mixtral_8x22b at full width
    as two gloo processes on the card, (1, 2) under ``make_rules()`` (EP 2
    x TP 2 + SP).  23a: 1 layer f32, no drops, the router term off, DSA
    off: the losses against the unsharded run's (gated,
    ``EP_F32_RTOL``), the all-to-alls and every other collective against
    the budget (gated), bytes a rank.  23b: ``launch.train`` at 2 layers
    bf16, capacity factor 1.25, the router term on, 4 x 4096 in 2
    microbatches: step ms against 17c's unsharded step, dropped share,
    all-to-all bytes, state bytes and peak a rank, losses (printed)."""
    import math
    from repro_torch.distributed import collectives as C
    from repro_torch.launch.mesh import run_spmd
    t0 = time.monotonic()
    card = smi()
    store = tempfile.mkdtemp()
    try:
        res = run_spmd(_p23_rank, 2, store_dir=store, backend="gloo",
                       device_ids=[0, 0], timeout_s=400, args=(seed,))
    finally:
        shutil.rmtree(store, ignore_errors=True)
    bad = []
    plain = res[0]["plain"]
    whole = res[0]["whole"]
    print(f"23a unsharded mixtral_8x22b 1 layer f32 (rank 0 alone, "
          f"{res[0]['plain_s']:.1f} s): {EP_STEPS} steps of {EP_BATCH} x "
          f"{EP_SEQ}, DSA off, capacity factor 4 (no drops), router term "
          f"off: losses " + ", ".join(f"{v:.6f}" for v in plain)
          + f" [{card}]", flush=True)
    for r, x in enumerate(res):
        a = x["23a"]
        rel = [abs(u - v) / abs(v) for u, v in zip(a["losses"], plain)]
        try:
            C.check_train_collectives(a["counts"], a["budget"])
            ok = True
        except AssertionError as e:
            print(f"  {e}", flush=True)
            ok = False
        print(f"  EP 2 x TP 2 + SP, rank {r} ({a['s']:.1f} s): EP taken "
              f"{a['ep']}; losses " + ", ".join(f"{v:.6f}"
                                                for v in a["losses"])
              + "; gap / loss " + ", ".join(f"{v:.3g}" for v in rel)
              + f" (gated: <= {EP_F32_RTOL:g}); all-to-all over model "
              f"{a['counts'].get(('all-to-all', 'model'), 0)} (budget "
              f"{a['budget'].get(('all-to-all', 'model'), 0)}); "
              "collectives " + ", ".join(
                  f"{op} {ax} {n}" for (op, ax), n in sorted(
                      a["counts"].items()))
              + f" == budget {ok}; bytes params {a['params']} of {whole} "
              f"({a['params'] / whole:.4f}; predicted {EP_STATE_PRED[0]}-"
              f"{EP_STATE_PRED[1]}), grads the params' shapes, moments "
              f"{a['moments']} of {2 * whole} "
              f"({a['moments'] / whole / 2:.4f}) [{card}]", flush=True)
        if not ok:
            bad.append(f"23a rank {r} budget")
        if not a["ep"] or max(rel) > EP_F32_RTOL:
            bad.append(f"23a rank {r}: EP {a['ep']}, gap {max(rel):.3g}")
    for r, x in enumerate(res):
        bb = x["23b"]
        tok = 4 * 4096
        print(f"23b mixtral_8x22b {bb['layers']} layers bf16, bf16 "
              f"moments, EP 2 x TP 2 + SP over gloo on one card "
              f"(launch.train, make_rules() on (1, 2)), 4 x 4096 in 2 "
              f"microbatches, capacity factor 1.25, router term on, rank "
              f"{r} ({bb['s']:.1f} s): step ms " + ", ".join(
                  f"{t * 1e3:.1f}" for t in bb["step_s"])
              + f" (median of steps 2-3 {bb['median_ms']:.1f}; predicted "
              f"{EP_STEP_PRED_MS[0]:.0f}-{EP_STEP_PRED_MS[1]:.0f}; 17c "
              f"unsharded {mix17c['step_ms']:.1f}), "
              f"{tok / bb['median_ms'] * 1e3:.0f} tok/s; dropped {bb['dropped']} of {bb['pairs']} (token, "
              f"slot) pairs ({100 * bb['dropped'] / bb['pairs']:.3f} %, "
              f"forward and recompute); cap {bb['cap']}; all-to-all "
              f"{bb['call_bytes'] / 1e6:.1f} MB a call (predicted ~126), "
              f"{bb['calls']} calls a step (budget {bb['budget_calls']}), "
              f"{bb['call_bytes'] * bb['calls'] / 1e9:.2f} GB a step; "
              f"state bytes {bb['state']} of {bb['whole']} unsharded "
              f"({bb['state'] / bb['whole']:.4f}); peak "
              f"{bb['peak_gib']:.2f} GiB; losses " + ", ".join(
                  f"{v:.4f}" for v in bb["losses"]) + "; router term "
              + ", ".join(f"{v:.6f}" for v in bb["router"])
              + f" (printed) [{card}]", flush=True)
        if not all(map(math.isfinite, bb["losses"])) or (
                bb["calls"] != bb["budget_calls"]):
            bad.append(f"23b rank {r}: losses {bb['losses']}, calls "
                       f"{bb['calls']} of {bb['budget_calls']}")
    print(f"phase 23: {time.monotonic() - t0:.1f} s", flush=True)
    if bad:
        fail(f"phase 23: {bad}")
    return {"23a": res[0]["23a"], "23b": res[0]["23b"]}


# -- the dry run's count against the card (phase 24) ---------------------------


def _dryrun_count(cfg, b: int, s: int, mb: int, opt) -> dict:
    """The dry run's count (``launch/dryrun.py``: fake tensors, the
    1-/2-group form) of one train step of ``cfg`` on ``b`` x ``s`` tokens
    in ``mb`` microbatches at world 1 (``mesh=None``), with the roofline
    at the H100's constants: FLOPs, bytes, compute_s, memory_s, the bound
    and mfu_bound (6 N_active D over the bound at 989 TFLOP/s)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import hlo_analysis as H
    from repro_torch.launch import dryrun as DR
    from repro_torch.training import steps as ST
    t0 = time.monotonic()
    shape = ShapeConfig("chip", s, b, "train")
    with DR._fake_mode():
        cost = DR.component_costs(cfg, shape, opt, None, None,
                                  ST.default_flags(cfg), mb)
    roof = H.roofline(cost["flops"], cost["bytes"], cost["coll"],
                      model_flops_global=6.0 * cfg.num_active_params()
                      * b * s, n_chips=1)
    return {"flops": cost["flops"], "bytes": cost["bytes"],
            "count_s": time.monotonic() - t0, **roof}


def dryrun_phase(torch, seed: int, yi16d: dict, mix17c: dict) -> dict:
    """24a.  The dry run's count of 16d's yi_6b train run (4 layers, 4 x
    4096, 2 microbatches, bf16 moments) and 17c's mixtral run (2 layers),
    at world 1 with the H100's constants, beside the steps this process
    measured: gated on compute_s <= the measured median (a step faster
    than its FLOPs allow means a wrong count or constant); memory_s
    printed against 16d's profiled busy time, not gated (eager ops that
    hit L2 beat it).  24b.  yi_6b's one rank at tp 16 served on the card
    (``shard_config``: 2 of its 32 query heads on 1 of its 4 KV heads,
    G 2, d_ff 688, all 32 layers, bf16, 4 x 4096, 32 new, DSA kernel),
    without the collectives: K2 once a layer in prefill, K1 once a layer
    a step, the tokens finite and in the vocab."""
    import functools

    import numpy as np
    from repro_torch.configs.base import cut_layers, get_config
    from repro_torch.distributed.sharding import shard_config
    from repro_torch.inference.engine import Engine
    from repro_torch.launch import serve
    from repro_torch.models.transformer import init_model
    from repro_torch.optim import adamw
    t0 = time.monotonic()
    out = {}
    opt = adamw.OptConfig(moment_dtype="bfloat16")
    runs = (("16d yi_6b", cut_layers(get_config("yi_6b"), YI_TRAIN_LAYERS),
             yi16d),
            ("17c mixtral_8x22b", dataclasses.replace(
                get_config("mixtral_8x22b"), n_layers=2), mix17c))
    for label, cfg, meas in runs:
        c = _dryrun_count(cfg, 4, 4096, meas["microbatches"], opt)
        med = meas["step_ms"] / 1e3
        line = (f"24a dry-run count of {label} ({cfg.n_layers} layers, 4 x "
                f"4096, {meas['microbatches']} microbatches, H100 "
                f"constants): {c['flops'] / 1e12:.2f} TFLOP, "
                f"{c['bytes'] / 1e9:.1f} GB; compute_s "
                f"{c['compute_s']:.4f}, memory_s {c['memory_s']:.4f}, "
                f"bound {c['bound_step_time_s']:.4f} s ({c['dominant']}), "
                f"mfu_bound {c['mfu_bound']:.3f}; measured median step "
                f"{med:.4f} s: compute_s / step {c['compute_s'] / med:.3f}, "
                f"bound / step {c['bound_step_time_s'] / med:.3f}")
        if "profile" in meas:
            busy = meas["profile"][1] / 1e3
            line += (f"; memory_s / profiled busy {busy:.4f} s = "
                     f"{c['memory_s'] / busy:.3f}")
        print(line + f" (counted in {c['count_s']:.1f} s)", flush=True)
        out[label] = dict(c, step_s=med)
        if not c["compute_s"] <= med:
            fail(f"24a: {label}'s compute_s {c['compute_s']:.4f} s exceeds "
                 f"the measured step {med:.4f} s")
    # 24b: one rank's layers at tp 16, collectives left out
    yi = get_config("yi_6b")
    mcfg = shard_config(yi, 16)
    b, prompt, n_new = 4, 4096, 32
    torch.cuda.empty_cache()
    serve.reset_launch_counts()
    eng = Engine(mcfg, functools.partial(init_model, seed, mcfg),
                 max_len=prompt + n_new + 16, long_context=True,
                 dsa_mode="kernel")
    prompts = np.random.default_rng(seed).integers(
        1, yi.vocab - 4, size=(b, prompt)).astype(np.int32)
    res = eng.generate(prompts, n_new)
    n = serve.launch_counts()
    want = {"K2": mcfg.n_layers, "K1": mcfg.n_layers * res.decode_steps}
    ok = bool((res.tokens >= 0).all() and (res.tokens < yi.vocab).all())
    print(f"24b yi_6b one rank at tp 16 (n_heads {mcfg.n_heads}, n_kv_heads "
          f"{mcfg.n_kv_heads}, d_ff {mcfg.d_ff}, {mcfg.n_layers} layers "
          f"bf16, {b} x {prompt}, {n_new} new, kernel): prefill "
          f"{res.prefill_s * 1e3:.1f} ms, decode {res.tokens_per_s:.1f} "
          f"tok/s over {res.decode_steps} steps; launches "
          + " ".join(f"{k} {v}" for k, v in n.items() if v)
          + f"; tokens in the vocab: {ok}", flush=True)
    bad = {k: v for k, v in n.items() if v != want.get(k, 0)}
    if bad or not ok:
        fail(f"24b: launches {bad} (want {want}), tokens ok {ok}")
    out["launches"] = dict(n)
    del eng
    torch.cuda.empty_cache()
    print(f"phase 24: {time.monotonic() - t0:.1f} s", flush=True)
    return out


# -- phase 25: tensor parallelism for cross-attention and RWKV6 ----------------

# the serving cells of 25a-c: (arch, decoder layers, batch, prompt, max_len);
# whisper whole (12 + 12), llama_3_2_vision at one group of 5 (its cross
# layer at 3), rwkv6_3b at 4 layers; 32 new tokens each, bf16 weights on a
# bf16 cache, kernel DSA
X_TP_CELLS = (("whisper_small", 12, 4, 384, 448),
              ("llama_3_2_vision", 5, 4, 4096, 4096 + 32 + 16),
              ("rwkv6_3b", 4, 4, 4096, 4096 + 32 + 16))
X_TP_NEW = 32
# 25d: TP 2 + SP training, f32, DSA off (the 4-bit predictor turns the tp
# sums' last bits into other blocks, 22a), 2 steps of 2 x seq: (arch,
# layers, seq); whisper at 2 + 2 layers over 1024 frames, llama at its one
# group of 5 (cut_layers keeps whole groups) with 1601 image tokens,
# rwkv6_3b at 2
X_TRAIN_CELLS = (("whisper_small", 2, 1024), ("llama_3_2_vision", 5, 1024),
                 ("rwkv6_3b", 2, 1024))
X_TRAIN_SEQ, X_TRAIN_BATCH, X_TRAIN_STEPS = 1024, 2, 2
# the continuous engine's requests (prompt, new) of a serving cell, where
# it runs one: whisper's 8 (25a); jamba's 6 in whole 128-token chunks of
# the Mamba scan (26a)
X_CONT_REQS = {
    "whisper_small": [(384, 32), (200, 24), (320, 16), (96, 32),
                      (256, 20), (128, 28), (300, 12), (64, 30)],
    "jamba_1_5_large": [(1024, 16), (2048, 12), (512, 24), (1536, 8),
                        (1024, 20), (768, 16)]}


def _one_rank_at_a_time(rank: int, make):
    """``make()`` (an engine drawing its weights) on rank 0, then on rank
    1, and neither goes on before both have drawn: a rank drawing holds
    its shards and one piece whole (a jamba MoE sub-block, 19.3 GB bf16,
    beside its 12.9 GB f32 draw), which two ranks drawing at once, or one
    drawing beside the other's prefill, would not fit on one card.  Rank
    0 keeps its weights on the host while rank 1 draws: beside rank 0's
    24.2 GB of jamba, rank 1's draw fell 0.1 GB short on a run whose
    other processes held more.  Returns the engine and the draw's
    margin: the card's free GiB before it and this rank's peak GiB
    during it."""
    import torch
    import torch.distributed as dist
    from repro_torch.tree import map_tree

    def moved(params, device):
        return map_tree(lambda t: t.to(device)
                        if isinstance(t, torch.Tensor) else t, params)

    if rank:
        dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    margin = dict(free=torch.cuda.mem_get_info()[0] / 2**30)
    out = make()
    margin["peak"] = torch.cuda.max_memory_allocated() / 2**30
    if not rank:
        out.params = moved(out.params, "cpu")
    # the draws' freed blocks back to the card before the other rank draws
    gc.collect()
    torch.cuda.empty_cache()
    if not rank:
        dist.barrier()
    dist.barrier()
    if not rank:
        out.params = moved(out.params, out.device)
    return out, margin


def _x_serve(rank: int, seed: int, arch: str, layers: int, b: int,
             plen: int, max_len: int) -> dict:
    """One of 25a-c on this rank: the engine at tp 2 draws its own
    weights (``init_model`` with its ``place``), every cross gate at 0.5;
    its prefill's last-row logits with DSA off and on the kernel path,
    then ``generate`` (``X_TP_NEW`` new) timed with its launches and
    collectives; rank 0 then the same unsharded for the gap and the
    greedy agreement.  With DSA off the last-row logits come from a
    forward without a cache, whisper's over its first 1024 frames: its
    1500-frame encoder has no DSA-off path (the q-chunked attention above
    1024 queries needs a multiple of 256, in the reference too).  An arch
    of ``X_CONT_REQS`` also runs the continuous engine on its requests
    (blocking admission), sharded and on rank 0 unsharded."""
    import functools
    import numpy as np
    import torch
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.sharding import tree_bytes
    from repro_torch.inference.engine import Engine
    from repro_torch.inference.scheduler import ContinuousEngine, Request
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models import moe
    from repro_torch.models import transformer as TT
    from repro_torch.distributed.sharding import tp_decode_all_reduces
    cfg = _xattn_cfg(arch, layers, f32=False)
    kw = dict(max_len=max_len, long_context=True, dsa_mode="kernel",
              cache_dtype=torch.bfloat16)
    rng = np.random.default_rng(seed)
    prompts = rng.integers(1, cfg.vocab - 4, size=(b, plen)).astype(np.int32)
    ex = serve.draw_extras(cfg, b, rng)
    ex_off = ({"enc_x": ex["enc_x"][:, :1024]} if cfg.enc_dec else ex)

    def logits(e):
        """Last-row logits with DSA off (no cache) and on the kernel path
        (the engine's prefill), and with a dense prologue (deepseek's)
        the DSA-off logits of the prologue alone; and the experts each MoE
        router call of the DSA-off forward picked for its last token."""
        toks = torch.as_tensor(prompts, device=e.device)
        flags = e.run_flags("prefill", "off")
        rows = torch.full((b,), plen - 1, device=e.device)
        picks, route = [], moe._route

        def recorded(w, x, k):
            got = route(w, x, k)
            picks.append(tuple(sorted(got[0][-1].tolist())))
            return got

        with torch.inference_mode():
            moe._route = recorded
            try:
                off = TT.forward(e.params, e.mcfg, flags, toks, None,
                                 extras={k: torch.as_tensor(v,
                                                            device=e.device)
                                         for k, v in ex_off.items()},
                                 last=rows)[0]
            finally:
                moe._route = route
            out = {"off": off.float().cpu()}
            if cfg.moe is not None and "prologue" in e.params:
                out["prologue"] = TT.forward(
                    {**e.params, "groups": []}, e.mcfg, flags, toks, None,
                    last=rows)[0].float().cpu()
        kern = e.prefill(prompts, caches=e.resident_cache(b),
                         dsa_mode="kernel", extras=ex)[0]
        out["kernel"] = kern.float().cpu()
        return out, picks

    mesh = make_serving_mesh(dp=1, tp=2, cfg=cfg)
    t0 = time.monotonic()
    eng, draw = _one_rank_at_a_time(rank, lambda: Engine(
        cfg, functools.partial(TT.init_model, seed, cfg), mesh=mesh, **kw))
    TT.set_cross_gates(eng.params, XATTN_GATE)
    last, picks = logits(eng)
    serve.reset_launch_counts()
    before = C.snapshot()
    res = eng.generate(prompts, X_TP_NEW, extras=ex)
    out = dict(shard=eng.weight_bytes_per_device(),
               prefill_ms=res.prefill_s * 1e3, tok_s=res.tokens_per_s,
               steps=res.decode_steps, launches=serve.launch_counts(),
               model=C.count_collectives(before, "model"),
               per_step=tp_decode_all_reduces(eng.mcfg), mcfg=(
                   eng.mcfg.n_heads, eng.mcfg.n_kv_heads, eng.mcfg.d_ff),
               tokens_ok=bool(res.tokens.min() >= 0
                              and res.tokens.max() < cfg.vocab), draw=draw)
    cont = None
    if arch in X_CONT_REQS:
        def reqs():
            r = np.random.default_rng(seed + 1)
            return [Request(i, r.integers(1, cfg.vocab - 4, size=(n,))
                            .astype(np.int32), k, seed=i)
                    for i, (n, k) in enumerate(X_CONT_REQS[arch])]
        ckw = dict(slots=4, seg_len=8, **kw)
        # the static engine's shards, as its draw placed them: a second
        # draw beside them would not fit jamba's two ranks on the card
        s = ContinuousEngine(cfg, lambda place: eng.params, mesh=mesh,
                             **ckw)
        serve.reset_launch_counts()
        t1 = time.monotonic()
        got = s.run(reqs())
        cont = dict(s=time.monotonic() - t1, n=len(got),
                    launches=serve.launch_counts(),
                    steps=s.stats["decode_steps"])
        del s
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    out["s"] = time.monotonic() - t0
    if rank == 0:
        params = TT.set_cross_gates(TT.init_model(seed, cfg), XATTN_GATE)
        out["whole"] = tree_bytes(params)
        plain = Engine(cfg, params, **kw)
        wants, plain_picks = logits(plain)
        for m, want in wants.items():
            out["gap", m] = float((last[m] - want).abs().max())
            out["scale", m] = float(want.abs().max())
        out["rerouted"] = (sum(a != c for a, c in zip(picks, plain_picks)),
                           len(plain_picks))
        ref = plain.generate(prompts, X_TP_NEW, extras=ex)
        out["agree"] = float((res.tokens == ref.tokens).mean())
        out["plain_prefill_ms"] = ref.prefill_s * 1e3
        out["plain_tok_s"] = ref.tokens_per_s
        if cont is not None:
            p = ContinuousEngine(cfg, params, slots=4, seg_len=8, **kw)
            want = p.run(reqs())
            cont["agree"] = float(np.mean([np.mean(got[r] == want[r])
                                           for r in want]))
            del p
        del plain, params
        torch.cuda.empty_cache()
    out["cont"] = cont
    return out


def _x_train(rank: int, seed: int, arch: str, layers: int, seq: int,
             moment_dtype: str = "float32") -> dict:
    """25d on this rank: ``arch`` at ``layers`` (f32, DSA off, every cross
    gate at 0.5; AdamW moments in ``moment_dtype``), ``X_TRAIN_STEPS``
    steps of ``X_TRAIN_BATCH`` x ``seq`` with the second input (whisper's
    over ``seq`` frames), unsharded on rank 0 alone (the other rank
    waits), then TP 2 + SP (``make_rules()`` on (1, 2)) on both: the
    losses, the counters and the budget."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.sharding import make_rules, tree_bytes
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as TT
    from repro_torch.models.attention import RunFlags
    from repro_torch.training import steps as ST
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _xattn_cfg(arch, layers, f32=True)
    opt = _p22_opt(X_TRAIN_STEPS, moment_dtype)
    flags = RunFlags(mode="train", dsa_mode="off")
    bs = _p22_batches(cfg.vocab, seq, X_TRAIN_BATCH, X_TRAIN_STEPS, seed)
    rng = np.random.default_rng(seed + 2)
    # whisper over seq frames: with DSA off its 1500 have no path (the
    # q-chunked attention above 1024 queries takes multiples of 256)
    key, t = (("enc_x", seq) if cfg.enc_dec else
              ("img", cfg.n_image_tokens) if cfg.cross_attn_period else
              (None, 0))
    for b in bs if key else ():
        b[key] = rng.standard_normal((X_TRAIN_BATCH, t, cfg.d_model)
                                     ).astype(np.float32)
    out = {}

    def run(mesh, rules):
        t0 = time.monotonic()
        state, _ = ST.init_train_state(seed, cfg, opt, mesh=mesh,
                                       rules=rules)
        TT.set_cross_gates(state["params"], XATTN_GATE)
        step = ST.make_train_step(cfg, opt, flags, mesh=mesh, rules=rules)
        before = C.snapshot()
        losses = [float(step(state, b)[1]["loss"]) for b in bs]
        res = dict(losses=losses, counts=C.count_by_axis(before),
                   params=tree_bytes(state["params"]),
                   s=time.monotonic() - t0)
        if mesh is not None:
            res["budget"] = step.plan.collective_budget(
                1, seq_len=seq, remat=cfg.remat, mse=False,
                steps=X_TRAIN_STEPS)
        del state, step
        gc.collect()
        torch.cuda.empty_cache()
        return res

    if rank == 0:           # alone on the card: the other rank waits
        out["plain"] = run(None, None)
    dist.barrier()
    out["tp"] = run(make_host_mesh(model=2), make_rules())
    out["whole"] = tree_bytes(TT.init_model(0, cfg, device="meta"))
    out["seq"] = seq
    return out


def _p25_rank(rank: int, seed: int) -> dict:
    """Phase 25 on one rank of two gloo processes sharing the card."""
    out = {}
    for arch, layers, b, plen, max_len in X_TP_CELLS:
        out["serve", arch] = _x_serve(rank, seed, arch, layers, b, plen,
                                      max_len)
    for arch, layers, seq in X_TRAIN_CELLS:
        out["train", arch] = _x_train(rank, seed, arch, layers, seq)
    return out


def _tp_serve_report(res, arch: str, layers: int, b: int, plen: int,
                     tag: str, want_launches, enc: int, card: str,
                     bad: list) -> None:
    """Print one tp-2 serving cell of ``_x_serve`` (both ranks' results
    ``res``) and add its failures to ``bad``: the DSA-off logit gap
    (gated, ``TP_LOGIT_TOL``; with a dense prologue its gap too, and the
    whole model's only where no MoE router call took other experts for
    a last row than unsharded), each rank's launches against
    ``want_launches(steps)`` and collectives against the budget (``enc``
    more all-reduces in the prefill, an encoder's), weight bytes about
    half the whole, tokens in the vocab, and the continuous engine's
    requests all served with K1 launched."""
    r0 = res[0]["serve", arch]
    modes = [m for m in ("off", "prologue", "kernel") if ("gap", m) in r0]
    rel = {m: r0["gap", m] / max(r0["scale", m], 1e-30) for m in modes}
    n, calls = r0["rerouted"]
    # with a dense prologue the gate reads it alone, and the whole model
    # too where no router call of the MoE layer after it turned the tp
    # sums' last bits into other experts for a last row
    gated = ({"prologue", "off"} if not n else {"prologue"}) if (
        "prologue" in rel) else {"off"}
    print(f"{tag} {arch} {layers} layers bf16 (a rank: heads, "
          f"KV heads, d_ff {r0['mcfg']}), tp 2 over gloo on one card, "
          f"{b} x {plen}, {X_TP_NEW} new, kernel DSA: prefill "
          f"{r0['prefill_ms']:.1f} ms (unsharded "
          f"{r0['plain_prefill_ms']:.1f}), decode {r0['tok_s']:.1f} "
          f"tok/s over {r0['steps']} eager steps (unsharded graphed "
          f"{r0['plain_tok_s']:.1f}), greedy agreement "
          f"{r0['agree']:.3f} (printed) [{card}]", flush=True)
    what = {"off": "DSA off", "kernel": "DSA kernel",
            "prologue": "DSA off, the dense prologue alone"}
    for m in modes:
        print(f"  last-row logits, {what[m]}: max |gap| "
              f"{r0['gap', m]:.4g} of max |logit| {r0['scale', m]:.4g} "
              f"= {rel[m]:.3g}" + (f" (gated: <= {TP_LOGIT_TOL:g})"
                                  if m in gated else " (printed)"),
              flush=True)
    if calls:
        print(f"  MoE router calls of the DSA-off forward whose last token "
              f"took other experts than unsharded: {n} of {calls} (printed)",
              flush=True)
    for m in sorted(gated):
        if rel[m] > TP_LOGIT_TOL:
            bad.append(f"{tag} logit gap ({what[m]}) {rel[m]:.3g}")
    whole = r0["whole"]
    for r, x in enumerate(res):
        x = x["serve", arch]
        n = {k: v for k, v in x["launches"].items() if v}
        steps = x["steps"]
        want_n = want_launches(steps)
        want_c = {"all-reduce": x["per_step"] * (steps + 1) + enc,
                  "all-gather": steps + 1}
        print(f"  rank {r} ({x['s']:.1f} s): weight bytes {x['shard']} "
              f"of {whole} replicated ({x['shard'] / whole:.4f}); drew "
              f"them with {x['draw']['free']:.2f} GiB of the card free, "
              f"peak {x['draw']['peak']:.2f} GiB; "
              f"launches {n} (want {want_n}); collectives over model "
              f"[{_collectives_line(x['model'])}] (budget "
              f"[{_collectives_line(want_c)}]: {x['per_step']} "
              f"all-reduces a decode step, the prefill the same"
              + (f" + {enc} of the encoder" if enc else "") + ")",
              flush=True)
        if (n != want_n or x["model"] != want_c or not x["tokens_ok"]
                or x["shard"] > 0.5 * whole + 0.1 * whole):
            bad.append(f"{tag} rank {r}")
        c = x["cont"]
        if c is not None:
            nc = {k: v for k, v in c["launches"].items() if v}
            print(f"  continuous, rank {r}: {c['n']} of "
                  f"{len(X_CONT_REQS[arch])} requests in "
                  f"{c['s']:.1f} s, {c['steps']} decode steps, launches "
                  f"{nc}" + (f", greedy agreement with the unsharded "
                             f"engine {c['agree']:.3f} (printed)"
                             if "agree" in c else ""), flush=True)
            if c["n"] != len(X_CONT_REQS[arch]) or not nc.get("K1"):
                bad.append(f"{tag} continuous rank {r}")


def _tp_train_report(res, arch: str, layers: int, tag: str, card: str,
                     bad: list) -> None:
    """Print one TP 2 + SP training cell of ``_x_train`` (both ranks'
    results ``res``) and add its failures to ``bad``: each rank's losses
    against the unsharded run's (gated, ``SHARD_F32_RTOL``) and its
    counters against the budget (gated)."""
    from repro_torch.distributed import collectives as C
    plain = res[0]["train", arch]["plain"]
    print(f"{tag} {arch} {layers} layers f32 (rank 0 alone, "
          f"{plain['s']:.1f} s): {X_TRAIN_STEPS} steps of "
          f"{X_TRAIN_BATCH} x {res[0]['train', arch]['seq']}, DSA off, "
          f"gates "
          f"{XATTN_GATE}: losses " + ", ".join(
              f"{v:.6f}" for v in plain["losses"]) + f" [{card}]",
          flush=True)
    for r, x in enumerate(res):
        a = x["train", arch]["tp"]
        rel = [abs(u - v) / abs(v) for u, v in zip(a["losses"],
                                                    plain["losses"])]
        try:
            C.check_train_collectives(a["counts"], a["budget"])
            ok = True
        except AssertionError as e:
            print(f"  {e}", flush=True)
            ok = False
        print(f"  TP 2 + SP, rank {r} ({a['s']:.1f} s): losses "
              + ", ".join(f"{v:.6f}" for v in a["losses"])
              + "; gap / loss " + ", ".join(f"{v:.3g}" for v in rel)
              + f" (gated: <= {SHARD_F32_RTOL:g}); collectives "
              + ", ".join(f"{op} {ax} {n}" for (op, ax), n in sorted(
                  a["counts"].items()))
              + f" == budget {ok}; params {a['params']} of "
              f"{x['train', arch]['whole']} bytes", flush=True)
        if not ok or max(rel) > SHARD_F32_RTOL:
            bad.append(f"{tag} {arch} rank {r}")


def xtp_phase(ranks) -> dict:
    """Phase 25, tensor parallelism for cross-attention and RWKV6: two
    gloo processes on the card at tp 2.  25a whisper_small whole (12 + 12
    layers, 4 x 384, 1500 frames) and its continuous engine on 8
    requests, 25b llama_3_2_vision at one group of 5 (4 x 4096, 1601
    image tokens), 25c rwkv6_3b at 4 layers (4 x 4096, K7 on each rank's
    20 heads), bf16, 32 new: greedy agreement with the unsharded run on
    rank 0 (printed), the last-row logit gap with DSA off (gated,
    ``TP_LOGIT_TOL``), weight bytes a rank, prefill ms, decode tok/s,
    launches (gated) and collectives against the budget (gated).  25d
    TP 2 + SP training in f32, DSA off: losses against the unsharded run
    (gated, ``SHARD_F32_RTOL``), counters against the budget (gated).
    ``ranks``: ``tp_ranks``'s results.  Returns rank 0's launches of each
    serving cell."""
    card = smi()
    res = [r[25] for r in ranks]
    bad = []
    tag = {"whisper_small": "25a", "llama_3_2_vision": "25b",
           "rwkv6_3b": "25c"}
    for arch, layers, b, plen, _ in X_TP_CELLS:
        _tp_serve_report(
            res, arch, layers, b, plen, tag[arch],
            lambda steps, a=arch, n=layers: (
                {"K7": n} if a == "rwkv6_3b" else {"K2": n, "K1": n * steps}),
            2 * layers if arch == "whisper_small" else 0, card, bad)
    for arch, layers, _ in X_TRAIN_CELLS:
        _tp_train_report(res, arch, layers, "25d", card, bad)
    print(f"phase 25: {ranks[0]['s'][25]:.1f} s (+ "
          f"{ranks[0]['s']['spawn']:.1f} s to spawn the ranks)", flush=True)
    if bad:
        fail(f"phase 25: {bad}")
    return {arch: res[0]["serve", arch]["launches"]
            for arch, *_ in X_TP_CELLS}


# -- phase 26: tensor parallelism for Mamba, MLA and the shared experts --------

# the serving cells of 26a-b, as 25's: jamba_1_5_large at 5 sub-blocks
# (Mamba, Mamba + MoE, Mamba, Mamba + MoE, attention; 48.2 GB bf16, half a
# rank) and deepseek_v3 at its 3-layer prologue and one MoE layer (30 GB);
# 4 x 2048 (16 chunks of the Mamba scan a row), 32 new
M_TP_CELLS = (("jamba_1_5_large", 5, 4, 2048, 2048 + 32 + 16),
              ("deepseek_v3", 4, 4, 2048, 2048 + 32 + 16))
# TP 2 + SP training, f32, DSA off, as 25d: jamba's first sub-block (Mamba
# and its dense MLP) at 2 x 512, deepseek's prologue (3.6 B params) at 2
# x 1024 with bf16 AdamW moments, whose f32 state two ranks on one card
# would not hold beside their steps; (arch, layers, seq, moment dtype)
M_TRAIN_CELLS = (("jamba_1_5_large", 1, 512, "float32"),
                 ("deepseek_v3", 3, 1024, "bfloat16"))
# 26b's EP 2 x TP 2 + SP layer: deepseek_v3's first MoE layer alone
# (first_k_dense 0) with its routed experts cut to M_EP_EXPERTS of 256
# (256 are 45 GB in f32, which two training ranks on one card cannot
# hold), top 8, capacity factor E / top_k (no pair dropped), the router
# term off, f32, DSA off; 2 steps of 2 x 1024
M_EP_EXPERTS = 16


def _m_ep(rank: int, seed: int) -> dict:
    """26b's EP layer on this rank: the first step's gradients and two
    steps' losses, unsharded on rank 0 alone (its gradients kept on the
    host; the other rank waits), then EP 2 x TP 2 + SP (``make_rules()``
    on (1, 2)) on both: the losses, the counters against the budget, and
    this rank's gradient of every leaf against its shard of the
    unsharded one (max |gap| / max |unsharded|)."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.sharding import make_rules, tree_bytes
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.attention import RunFlags
    from repro_torch.training import steps as ST
    from repro_torch.tree import named_leaves
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("deepseek_v3")
    mo = dataclasses.replace(cfg.moe, num_experts=M_EP_EXPERTS,
                             first_k_dense=0, router_aux_weight=0.0,
                             capacity_factor=M_EP_EXPERTS / cfg.moe.top_k)
    cfg = dataclasses.replace(cfg, n_layers=1, moe=mo, dtype="float32",
                              param_dtype="float32")
    opt = _p22_opt(X_TRAIN_STEPS)
    flags = RunFlags(mode="train", dsa_mode="off")
    bs = _p22_batches(cfg.vocab, X_TRAIN_SEQ, X_TRAIN_BATCH, X_TRAIN_STEPS,
                      seed)

    def run(mesh, rules):
        t0 = time.monotonic()
        state, _ = ST.init_train_state(seed, cfg, opt, mesh=mesh,
                                       rules=rules)
        step = ST.make_train_step(cfg, opt, flags, mesh=mesh, rules=rules)
        grads, _ = ST.accumulate_grads(state["params"], cfg, flags, bs[0],
                                       1, step.plan)
        grads = {p: g.detach().cpu() for p, g in named_leaves(grads)}
        before = C.snapshot()
        losses = [float(step(state, b)[1]["loss"]) for b in bs]
        res = dict(losses=losses, counts=C.count_by_axis(before),
                   grads=grads, params=tree_bytes(state["params"]),
                   s=time.monotonic() - t0, plan=step.plan)
        del state, step
        torch.cuda.empty_cache()
        return res

    out, plain = {}, None
    if rank == 0:           # alone on the card: the other rank waits
        plain = run(None, None)
        out["plain"] = dict(losses=plain["losses"], s=plain["s"],
                            params=plain["params"])
    dist.barrier()
    mesh = make_host_mesh(model=2)
    got = run(mesh, make_rules())
    plan = got.pop("plan")
    got["ep"] = plan.ep_active(X_TRAIN_SEQ)
    got["budget"] = plan.collective_budget(
        1, seq_len=X_TRAIN_SEQ, remat=cfg.remat, mse=False,
        steps=X_TRAIN_STEPS)
    if plain is not None:
        gaps = {}
        for p, g in got["grads"].items():
            want = plan.shard(plain["grads"][p], p)
            gaps[p] = float((g - want).abs().max()) / max(
                float(want.abs().max()), 1e-30)
        got["gaps"] = gaps
    del got["grads"]
    out["ep"] = got
    return out


def _p25_26_rank(rank: int, seed: int) -> dict:
    """Phases 26 and 25 on one rank, one after the other (26's large
    draws first, in a fresh process), with the seconds each took."""
    t0 = time.monotonic()
    out = {26: _p26_rank(rank, seed)}
    t1 = time.monotonic()
    out[25] = _p25_rank(rank, seed)
    out["s"] = {26: t1 - t0, 25: time.monotonic() - t1}
    return out


def tp_ranks(seed: int) -> list:
    """Phases 25 and 26's two gloo processes sharing the card, spawned
    once for both (a spawn takes seconds): each rank's results."""
    from repro_torch.launch.mesh import run_spmd
    t0 = time.monotonic()
    store = tempfile.mkdtemp()
    try:
        res = run_spmd(_p25_26_rank, 2, store_dir=store, backend="gloo",
                       device_ids=[0, 0], timeout_s=900, args=(seed,))
    finally:
        shutil.rmtree(store, ignore_errors=True)
    spawn = time.monotonic() - t0 - max(r["s"][25] + r["s"][26] for r in res)
    for r in res:
        r["s"]["spawn"] = spawn
    return res


def _p26_rank(rank: int, seed: int) -> dict:
    """Phase 26 on one rank of two gloo processes sharing the card."""
    out = {}
    for arch, layers, b, plen, max_len in M_TP_CELLS:
        out["serve", arch] = _x_serve(rank, seed, arch, layers, b, plen,
                                      max_len)
    for arch, layers, seq, moments in M_TRAIN_CELLS:
        out["train", arch] = _x_train(rank, seed, arch, layers, seq,
                                      moments)
    out["ep"] = _m_ep(rank, seed)
    return out


def mtp_phase(ranks) -> dict:
    """Phase 26, tensor parallelism for Mamba, MLA and the shared experts:
    two gloo processes on the card at tp 2.  26a jamba_1_5_large at 5
    sub-blocks (4 x 2048; each rank half of Mamba's 16384 inner channels,
    ``in_proj`` half by half, and 32 query heads on 4 KV heads: K2 once a
    prefill, K1 once a step) and its continuous engine on 6 requests;
    26b deepseek_v3's prologue and one MoE layer (4 x 2048; 64 of the 128
    MLA heads a rank, the latent cache whole, no kernel): greedy
    agreement with the unsharded run on rank 0 (printed), the DSA-off
    logit gap (gated, ``TP_LOGIT_TOL``; deepseek's over its dense prologue
    alone, and the whole model's where none of the MoE router calls took
    other experts for its last token than unsharded, which it prints),
    launches and collectives against the
    budget (gated), as phase 25's cells.  TP 2 + SP training in f32,
    DSA off, of jamba's first sub-block and deepseek's prologue (its
    AdamW moments bf16): losses
    against the unsharded run (gated, ``SHARD_F32_RTOL``) and counters
    against the budget (gated).  deepseek's first MoE layer with 16
    routed experts under EP 2 x TP 2 + SP: the losses and every leaf's
    gradient on rank 0 (the shared experts' among them) against the
    unsharded run (gated, ``SHARD_F32_RTOL``), counters against the
    budget (gated).  ``ranks``: ``tp_ranks``'s results.  Returns rank 0's
    launches of jamba's serving cell."""
    from repro_torch.distributed import collectives as C
    card = smi()
    res = [r[26] for r in ranks]
    bad = []
    tag = {"jamba_1_5_large": "26a", "deepseek_v3": "26b"}
    for arch, layers, b, plen, _ in M_TP_CELLS:
        _tp_serve_report(
            res, arch, layers, b, plen, tag[arch],
            lambda steps, a=arch: ({"K2": 1, "K1": steps}
                                   if a == "jamba_1_5_large" else {}),
            0, card, bad)
    for arch, layers, *_ in M_TRAIN_CELLS:
        _tp_train_report(res, arch, layers, tag[arch], card, bad)
    plain = res[0]["ep"]["plain"]
    print(f"26b deepseek_v3 1 MoE layer ({M_EP_EXPERTS} routed experts of "
          f"256, top 8, 1 shared) f32, DSA off, no drops, router term off "
          f"(rank 0 alone, {plain['s']:.1f} s, params {plain['params']} "
          f"bytes): {X_TRAIN_STEPS} steps of {X_TRAIN_BATCH} x "
          f"{X_TRAIN_SEQ}: losses " + ", ".join(
              f"{v:.6f}" for v in plain["losses"]) + f" [{card}]",
          flush=True)
    for r, x in enumerate(res):
        a = x["ep"]["ep"]
        rel = [abs(u - v) / abs(v) for u, v in zip(a["losses"],
                                                    plain["losses"])]
        try:
            C.check_train_collectives(a["counts"], a["budget"])
            ok = True
        except AssertionError as e:
            print(f"  {e}", flush=True)
            ok = False
        print(f"  EP 2 x TP 2 + SP, rank {r} ({a['s']:.1f} s): EP taken "
              f"{a['ep']}; losses " + ", ".join(f"{v:.6f}"
                                                for v in a["losses"])
              + "; gap / loss " + ", ".join(f"{v:.3g}" for v in rel)
              + f" (gated: <= {SHARD_F32_RTOL:g}); collectives "
              + ", ".join(f"{op} {ax} {n}" for (op, ax), n in sorted(
                  a["counts"].items()))
              + f" == budget {ok}; params {a['params']} bytes", flush=True)
        if not ok or not a["ep"] or max(rel) > SHARD_F32_RTOL:
            bad.append(f"26b EP rank {r}")
        if "gaps" in a:
            gaps = a["gaps"]
            shared = {p.rsplit("/", 1)[-1]: g for p, g in gaps.items()
                      if p.rsplit("/", 1)[-1] in ("sw1", "sw3", "sw2")}
            worst = max(gaps, key=gaps.get)
            print(f"  rank {r}'s gradients against its shards of the "
                  f"unsharded ones, {len(gaps)} leaves: worst {worst} "
                  f"{gaps[worst]:.3g}; shared experts " + ", ".join(
                      f"{k} {v:.3g}" for k, v in sorted(shared.items()))
                  + f" (gated: <= {SHARD_F32_RTOL:g})", flush=True)
            if len(shared) != 3 or gaps[worst] > SHARD_F32_RTOL:
                bad.append(f"26b EP gradients rank {r}")
    print(f"phase 26: {ranks[0]['s'][26]:.1f} s", flush=True)
    if bad:
        fail(f"phase 26: {bad}")
    return res[0]["serve", "jamba_1_5_large"]["launches"]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        fail(f"repro_torch not found next to this script ({e})")

    card = smi()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    last = [time.monotonic()]

    def mark(phase: str) -> None:
        """Print the seconds since the previous mark (each phase's own)."""
        now = time.monotonic()
        print(f"phase {phase}: {now - last[0]:.1f} s", flush=True)
        last[0] = now

    secs = build.build_all()
    print(f"build: {secs:.1f} s for {len(build.SOURCES)} sources")
    spills = []
    for name, log in build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
            if (name in NO_SPILL and "spill" in line
                    and "0 bytes spill stores, 0 bytes spill loads" not in line):
                spills.append(f"{name}: {line.strip()}")
    if spills:
        fail(f"ptxas spills registers in {spills}")

    timer = Timer(torch)
    k1_checks = [
        check_k1(torch, timer, b=2, hq=8, hkv=2, hd=16, s=100, bk=16,
                 q_dt="float32", c_dt="float32", kv_len=[100, 63], nb=5,
                 seed=args.seed, timed=False),
        check_k1(torch, timer, b=4, hq=32, hkv=4, hd=128, s=4224, bk=128,
                 q_dt="bfloat16", c_dt="bfloat16",
                 kv_len=[4160, 4100, 4097, 4133], nb=6, seed=args.seed,
                 timed=True),
        # the main path's case: bf16 q against the default f32 cache
        check_k1(torch, timer, b=4, hq=32, hkv=4, hd=128, s=4224, bk=128,
                 q_dt="bfloat16", c_dt="float32",
                 kv_len=[4160, 4100, 4097, 4133], nb=6, seed=args.seed,
                 timed=True),
        # the full-width body (hd 128, G 8) at f32 precision
        check_k1(torch, timer, b=4, hq=32, hkv=4, hd=128, s=4224, bk=128,
                 q_dt="float32", c_dt="float32",
                 kv_len=[4160, 4100, 4097, 4133], nb=6, seed=args.seed,
                 timed=False),
    ]
    k2_checks = [
        check_k2(torch, timer, b=2, hq=8, hkv=2, hd=16, l=128, blk=16, nb=3,
                 dtype="float32", seed=args.seed, timed=False),
        check_k2(torch, timer, b=2, hq=8, hkv=2, hd=16, l=128, blk=16, nb=3,
                 dtype="bfloat16", seed=args.seed, timed=False),
        check_k2(torch, timer, b=4, hq=32, hkv=4, hd=128, l=4096, blk=128,
                 nb=3, dtype="bfloat16", seed=args.seed, timed=True),
        # the f32 body at full width (the f32 parity phase runs it)
        check_k2(torch, timer, b=1, hq=32, hkv=4, hd=128, l=1024, blk=128,
                 nb=3, dtype="float32", seed=args.seed, timed=False),
        # stablelm_3b's prefill: hd 80 (a 160-byte row, the 128-column
        # instance), one query head per KV head
        check_k2(torch, timer, b=1, hq=32, hkv=32, hd=80, l=4096, blk=128,
                 nb=3, dtype="bfloat16", seed=args.seed, timed=False),
    ]
    # the sliding-window path: h2o_danube_1_8b's reduced geometry (window
    # 64 at block 16) in both bodies, its f32 parity run's (hd 80, G 4,
    # window 4096, L 4352) and its prefill's, timed (the kernels line's
    # window entry)
    k2w_checks = [
        check_k2(torch, timer, b=2, hq=4, hkv=2, hd=16, l=256, blk=16, nb=2,
                 window=64, dtype=dt, seed=args.seed, timed=False)
        for dt in ("float32", "bfloat16")] + [
        check_k2(torch, timer, b=1, hq=32, hkv=8, hd=80, l=4352, blk=128,
                 nb=6, window=4096, dtype="float32", seed=args.seed,
                 timed=False),
        check_k2(torch, timer, b=4, hq=32, hkv=8, hd=80, l=8192, blk=128,
                 nb=6, window=4096, dtype="bfloat16", seed=args.seed,
                 timed=True)]
    # the window path at mixtral_8x22b's geometry (hd 128, G 6): its f32
    # parity run's (B 2, L 4352) and its prefill's (B 4, L 8192, bf16,
    # timed: the kernels line's mixtral entry)
    k2m_checks = [
        check_k2(torch, timer, b=2, hq=48, hkv=8, hd=128, l=4352, blk=128,
                 nb=6, window=4096, dtype="float32", seed=args.seed,
                 timed=False),
        check_k2(torch, timer, b=4, hq=48, hkv=8, hd=128, l=8192, blk=128,
                 nb=6, window=4096, dtype="bfloat16", seed=args.seed,
                 timed=True)]
    # jamba_1_5_large's attention layer: hd 128, 64 query heads on 8 KV
    # heads; its prefill (B 4, L 4096, bf16, timed) and decode step (a
    # bf16 q against the 4144-row bf16 cache of the static slice, timed);
    # the reduced parity run's geometry (hd 16, f32)
    k2j_checks = [
        check_k2(torch, timer, b=2, hq=4, hkv=2, hd=16, l=256, blk=16, nb=3,
                 dtype="float32", seed=args.seed, timed=False),
        check_k2(torch, timer, b=4, hq=64, hkv=8, hd=128, l=4096, blk=128,
                 nb=3, dtype="bfloat16", seed=args.seed, timed=True)]
    k1j_checks = [
        check_k1(torch, timer, b=2, hq=4, hkv=2, hd=16, s=288, bk=16,
                 q_dt="float32", c_dt="float32", kv_len=[270, 257], nb=5,
                 seed=args.seed, timed=False),
        check_k1(torch, timer, b=4, hq=64, hkv=8, hd=128, s=4144, bk=128,
                 q_dt="bfloat16", c_dt="bfloat16",
                 kv_len=[4100, 4127, 4097, 4111], nb=6, seed=args.seed,
                 timed=True)]
    # whisper_small (MHA: hd 64, G 1; the launch_tc<64> instance in bf16):
    # its decoder's prefill (B 4, L 384, 2 of 3 blocks kept; bf16 timed,
    # and 20a's f32), its encoder's non-causal selection at 20a's reduced
    # geometry (hd 16, block 16) and at full width (hd 64, 1536 frames:
    # no model path takes it there, whose 1500 frames take the token
    # fallback), and its decode step (a bf16 q against the 512-row bf16
    # cache of 20b, 3 blocks kept; timed, and f32)
    k2w_ = dict(hq=12, hkv=12, hd=64, blk=128, seed=args.seed)
    k2x_checks = [
        check_k2(torch, timer, b=4, l=384, nb=2, dtype="bfloat16",
                 timed=True, **k2w_),
        check_k2(torch, timer, b=2, l=384, nb=2, dtype="float32",
                 timed=False, **k2w_),
        check_k2(torch, timer, b=2, hq=4, hkv=4, hd=16, l=64, blk=16, nb=2,
                 dtype="float32", seed=args.seed, timed=False,
                 causal=False),
        check_k2(torch, timer, b=4, l=1536, nb=2, dtype="bfloat16",
                 timed=False, causal=False, **k2w_)]
    k1x_checks = [
        check_k1(torch, timer, b=4, hq=12, hkv=12, hd=64, s=512, bk=128,
                 q_dt=dt, c_dt=dt, kv_len=[448, 421, 386, 400], nb=3,
                 seed=args.seed, timed=dt == "bfloat16")
        for dt in ("bfloat16", "float32")]
    # llama_3_2_vision (hd 128, 32 query heads on 8 KV heads, G 4): its
    # prefill (B 4, L 4096, 3 of 32 blocks kept; bf16 timed, and 20a's
    # f32 at L 1024) and decode step (the 4224-row bf16 cache of 20c, 6
    # blocks kept; timed, and f32)
    k2v_checks = [
        check_k2(torch, timer, b=4, hq=32, hkv=8, hd=128, l=4096, blk=128,
                 nb=3, dtype="bfloat16", seed=args.seed, timed=True),
        check_k2(torch, timer, b=2, hq=32, hkv=8, hd=128, l=1024, blk=128,
                 nb=3, dtype="float32", seed=args.seed, timed=False)]
    k1v_checks = [
        check_k1(torch, timer, b=4, hq=32, hkv=8, hd=128, s=4224, bk=128,
                 q_dt=dt, c_dt=dt, kv_len=[4129, 4100, 4097, 4111], nb=6,
                 seed=args.seed, timed=dt == "bfloat16")
        for dt in ("bfloat16", "float32")]
    # yi_6b at tp 2 (phase 21b): one rank's 16 query heads on 2 KV heads
    # (G 8, as unsharded); its prefill (B 4, L 4096, bf16, timed) and
    # decode step (a bf16 q against the 4224-row default f32 cache, timed)
    k2t_checks = [
        check_k2(torch, timer, b=4, hq=16, hkv=2, hd=128, l=4096, blk=128,
                 nb=3, dtype="bfloat16", seed=args.seed, timed=True)]
    k1t_checks = [
        check_k1(torch, timer, b=4, hq=16, hkv=2, hd=128, s=4224, bk=128,
                 q_dt="bfloat16", c_dt="float32",
                 kv_len=[4129, 4100, 4097, 4111], nb=6, seed=args.seed,
                 timed=True)]
    # yi_6b at tp 16 (phase 24b): one rank's 2 query heads on the one KV
    # head of their group (G 2); its prefill and decode step, as above
    k2t16_checks = [
        check_k2(torch, timer, b=4, hq=2, hkv=1, hd=128, l=4096, blk=128,
                 nb=3, dtype="bfloat16", seed=args.seed, timed=True)]
    k1t16_checks = [
        check_k1(torch, timer, b=4, hq=2, hkv=1, hd=128, s=4224, bk=128,
                 q_dt="bfloat16", c_dt="float32",
                 kv_len=[4129, 4100, 4097, 4111], nb=6, seed=args.seed,
                 timed=True)]
    # phase 25's tp-2 ranks: whisper_small's 6 query heads on 6 KV heads
    # (G 1, hd 64: the launch_tc<64> instance; 4 x 384, its 512-row bf16
    # cache) and llama_3_2_vision's 16 on 4 (G 4, hd 128; 4 x 4096, its
    # 4224-row bf16 cache); prefill and decode step, bf16 timed, and f32
    k2xt_checks = [
        check_k2(torch, timer, b=4, hq=6, hkv=6, hd=64, l=384, blk=128,
                 nb=2, dtype=dt, seed=args.seed, timed=dt == "bfloat16")
        for dt in ("bfloat16", "float32")]
    k1xt_checks = [
        check_k1(torch, timer, b=4, hq=6, hkv=6, hd=64, s=512, bk=128,
                 q_dt=dt, c_dt=dt, kv_len=[448, 421, 386, 400], nb=3,
                 seed=args.seed, timed=dt == "bfloat16")
        for dt in ("bfloat16", "float32")]
    k2vt_checks = [
        check_k2(torch, timer, b=4, hq=16, hkv=4, hd=128, l=4096, blk=128,
                 nb=3, dtype="bfloat16", seed=args.seed, timed=True),
        check_k2(torch, timer, b=2, hq=16, hkv=4, hd=128, l=1024, blk=128,
                 nb=3, dtype="float32", seed=args.seed, timed=False)]
    k1vt_checks = [
        check_k1(torch, timer, b=4, hq=16, hkv=4, hd=128, s=4224, bk=128,
                 q_dt=dt, c_dt=dt, kv_len=[4129, 4100, 4097, 4111], nb=6,
                 seed=args.seed, timed=dt == "bfloat16")
        for dt in ("bfloat16", "float32")]
    # phase 26a's tp-2 rank of jamba_1_5_large: 32 query heads on 4 KV
    # heads (G 8, hd 128; 4 x 2048, its 2096-row bf16 cache); prefill and
    # decode step, bf16 timed, and f32
    k2jt_checks = [
        check_k2(torch, timer, b=4, hq=32, hkv=4, hd=128, l=2048, blk=128,
                 nb=3, dtype="bfloat16", seed=args.seed, timed=True),
        check_k2(torch, timer, b=2, hq=32, hkv=4, hd=128, l=1024, blk=128,
                 nb=3, dtype="float32", seed=args.seed, timed=False)]
    k1jt_checks = [
        check_k1(torch, timer, b=4, hq=32, hkv=4, hd=128, s=2096, bk=128,
                 q_dt=dt, c_dt=dt, kv_len=[2052, 2079, 2049, 2063], nb=6,
                 seed=args.seed, timed=dt == "bfloat16")
        for dt in ("bfloat16", "float32")]
    k3_checks = [
        check_k3(torch, timer, b=2, hq=8, hkv=2, hd=16, s=100, c=32, blk=16,
                 q_dt="float32", c_dt="float32", q_off=[64, 32],
                 chunk_len=[36, 5], seed=args.seed, timed=False),
    ] + [
        # yi_6b's chunk: C 512 at depths 512..3584 of a 4096-row bucket, the
        # last row a partial final chunk; bf16 q against the default f32
        # cache is the main path's case
        check_k3(torch, timer, b=4, hq=32, hkv=4, hd=128, s=4096, c=512,
                 blk=128, q_dt=q_dt, c_dt=c_dt,
                 q_off=[3584, 2048, 512, 3072], chunk_len=[512, 512, 512, 300],
                 seed=args.seed, timed=(q_dt, c_dt) == ("bfloat16", "float32"))
        for q_dt, c_dt in (("bfloat16", "float32"), ("bfloat16", "bfloat16"),
                           ("float32", "float32"))]
    k4_checks = [
        check_k4(torch, timer, b=2, hq=8, hkv=2, hd=16, s=100, bk=16,
                 q_dt="float32", c_dt="float32", kv_len=[100, 63], nb=5,
                 seed=args.seed, timed=False)
    ] + [
        check_k4(torch, timer, b=4, hq=32, hkv=4, hd=128, s=4224, bk=128,
                 q_dt=q_dt, c_dt=c_dt, kv_len=[4160, 4100, 4097, 4133],
                 nb=6, seed=args.seed,
                 timed=(q_dt, c_dt) == ("bfloat16", "float32"))
        for q_dt, c_dt in (("bfloat16", "bfloat16"), ("bfloat16", "float32"),
                           ("float32", "float32"))] + [
        # the shape the continuous slice gives K4 (the kernels line's
        # entry): a logical cache of 64 blocks (max_len 8192) over the
        # default pool of 4 x 64 + 1 pages, a 9-block selection, ragged
        # depths, bf16 q against the default f32 pool
        check_k4(torch, timer, b=4, hq=32, hkv=4, hd=128, s=8192, bk=128,
                 q_dt="bfloat16", c_dt="float32",
                 kv_len=[4160, 2650, 1200, 3700], nb=9, pages=4 * 64 + 1,
                 seed=args.seed, timed=True)]
    # the quantized bodies (K6 of the TPU kernels): int8 and fp8 caches at
    # the reduced geometry and at the shapes the quantized slices give
    # them, bf16 q; K5 and K5q on a shuffled pool holding K3's cache
    q_checks = {}
    for quant in ("int8", "fp8"):
        q_checks["K1q", quant] = [
            check_k1(torch, timer, b=2, hq=8, hkv=2, hd=16, s=100, bk=16,
                     q_dt="float32", c_dt="float32", kv_len=[100, 63], nb=5,
                     seed=args.seed, timed=False, quant=quant),
            check_k1(torch, timer, b=4, hq=32, hkv=4, hd=128, s=4224,
                     bk=128, q_dt="bfloat16", c_dt="float32",
                     kv_len=[4160, 4100, 4097, 4133], nb=6, seed=args.seed,
                     timed=True, quant=quant)]
        q_checks["K4q", quant] = [
            check_k4(torch, timer, b=2, hq=8, hkv=2, hd=16, s=100, bk=16,
                     q_dt="float32", c_dt="float32", kv_len=[100, 63], nb=5,
                     seed=args.seed, timed=False, quant=quant),
            check_k4(torch, timer, b=4, hq=32, hkv=4, hd=128, s=8192,
                     bk=128, q_dt="bfloat16", c_dt="float32",
                     kv_len=[4160, 2650, 1200, 3700], nb=9,
                     pages=4 * 64 + 1, seed=args.seed, timed=True,
                     quant=quant)]
        q_checks["K3q", quant] = [
            check_k3(torch, timer, b=2, hq=8, hkv=2, hd=16, s=100, c=32,
                     blk=16, q_dt="float32", c_dt="float32", q_off=[64, 32],
                     chunk_len=[36, 5], seed=args.seed, timed=False,
                     quant=quant),
            check_k3(torch, timer, b=4, hq=32, hkv=4, hd=128, s=4096, c=512,
                     blk=128, q_dt="bfloat16", c_dt="float32",
                     q_off=[3584, 2048, 512, 3072],
                     chunk_len=[512, 512, 512, 300], seed=args.seed,
                     timed=True, quant=quant)]
    for quant in (None, "int8", "fp8"):
        q_checks["K5q" if quant else "K5", quant] = [
            check_k3(torch, timer, b=2, hq=8, hkv=2, hd=16, s=96, c=32,
                     blk=16, q_dt="float32", c_dt="float32", q_off=[64, 32],
                     chunk_len=[32, 5], seed=args.seed, timed=False,
                     quant=quant, paged=True),
            check_k3(torch, timer, b=4, hq=32, hkv=4, hd=128, s=4096, c=512,
                     blk=128, q_dt="bfloat16", c_dt="float32",
                     q_off=[3584, 2048, 512, 3072],
                     chunk_len=[512, 512, 512, 300], seed=args.seed,
                     timed=True, quant=quant, paged=True)]
    for name, checks in [("K1 dsa_decode", k1_checks),
                         ("K2 dsa_attention", k2_checks),
                         ("K2 dsa_attention (window)", k2w_checks),
                         ("K2 dsa_attention (window, mixtral)", k2m_checks),
                         ("K2 dsa_attention (jamba)", k2j_checks),
                         ("K1 dsa_decode (jamba)", k1j_checks),
                         ("K2 dsa_attention (whisper)", k2x_checks),
                         ("K1 dsa_decode (whisper)", k1x_checks),
                         ("K2 dsa_attention (llama vision)", k2v_checks),
                         ("K1 dsa_decode (llama vision)", k1v_checks),
                         ("K2 dsa_attention (yi tp 2)", k2t_checks),
                         ("K1 dsa_decode (yi tp 2)", k1t_checks),
                         ("K2 dsa_attention (yi tp 16 rank)", k2t16_checks),
                         ("K1 dsa_decode (yi tp 16 rank)", k1t16_checks),
                         ("K2 dsa_attention (whisper tp 2)", k2xt_checks),
                         ("K1 dsa_decode (whisper tp 2)", k1xt_checks),
                         ("K2 dsa_attention (llama tp 2)", k2vt_checks),
                         ("K1 dsa_decode (llama tp 2)", k1vt_checks),
                         ("K2 dsa_attention (jamba tp 2)", k2jt_checks),
                         ("K1 dsa_decode (jamba tp 2)", k1jt_checks),
                         ("K3 dsa_chunk_prefill", k3_checks),
                         ("K4 dsa_decode_paged", k4_checks)] + [
            (f"{k} {q or ''}".strip(), v) for (k, q), v in q_checks.items()]:
        for c in checks:
            line = (f"{name} [{c['geometry']}]: max abs err "
                    f"{c['max_abs_err']:.3g} (atol {c['tol'][0]:g} + rtol "
                    f"{c['tol'][1]:g} x |plain|; {100 * c['tol_used']:.1f} % "
                    f"of it used)")
            for key, what in (("equal_k1", "K1"), ("equal_k3", "K3"),
                              ("equal_unquantized", "the unquantized "
                               "kernel on the dequantized cache")):
                if key in c:
                    line += f", bitwise equal to {what}: {c[key]}"
            if "ms" in c:
                line += (f", kernel {c['ms']:.4f} ms (host enqueue "
                         f"{c['host_us']:.1f} us), plain "
                         f"{c['plain_ms']:.4f} ms, library "
                         f"{c['library_ms']:.4f} ms, bound "
                         f"{c['bound_ms']:.4f} ms ({c['bound_by']})")
            print(line, flush=True)
    k7_checks = [
        check_k7(torch, timer, b=2, h=4, s=128, hd=16, dtype="float32",
                 seed=args.seed, timed=False),
        check_k7(torch, timer, b=2, h=4, s=128, hd=16, dtype="float32",
                 seed=args.seed, timed=False, w_const=0.3),
        # rwkv6_3b's prefill: the main path's case is bf16
        check_k7(torch, timer, b=4, h=40, s=4096, hd=64, dtype="bfloat16",
                 seed=args.seed, timed=True),
        check_k7(torch, timer, b=4, h=40, s=4096, hd=64, dtype="float32",
                 seed=args.seed, timed=False),
        check_k7(torch, timer, b=4, h=40, s=4096, hd=64, dtype="float32",
                 seed=args.seed, timed=False, w_const=0.3),
        # the main path's dtype where the clamp binds, from a zero and a
        # random state
        check_k7(torch, timer, b=4, h=40, s=4096, hd=64, dtype="bfloat16",
                 seed=args.seed + 1, timed=False, w_const=0.3),
        # a blocking admission of the continuous engine: one row
        check_k7(torch, timer, b=1, h=40, s=2048, hd=64, dtype="bfloat16",
                 seed=args.seed, timed=False),
    ]
    # one tp-2 rank of rwkv6_3b's prefill (phase 25c): its 20 heads, bf16
    # timed, and f32, from a zero and a random state
    k7t_checks = [
        check_k7(torch, timer, b=4, h=20, s=4096, hd=64, dtype=dt,
                 seed=args.seed, timed=dt == "bfloat16")
        for dt in ("bfloat16", "float32")]
    for c in k7_checks + k7t_checks:
        line = (f"K7 wkv6 [{c['geometry']}]: max abs err "
                f"{c['max_abs_err']:.3g} (atol {c['tol'][0]:g} + rtol "
                f"{c['tol'][1]:g} x |plain|; {100 * c['tol_used']:.1f} % of "
                f"it used; y and s_last, zero and random s0: "
                + ", ".join(f"{k} {e:.3g}/{100 * u:.1f} %"
                            for k, (e, u) in c["parts"].items()) + ")")
        if "ms" in c:
            line += (f", kernel {c['ms']:.4f} ms (host enqueue "
                     f"{c['host_us']:.1f} us), plain {c['plain_ms']:.4f} "
                     f"ms, library none, bound {c['bound_ms']:.4f} ms "
                     f"({c['bound_by']}: {c['flops'] / 1e9:.2f} GFLOP, "
                     f"{c['bytes'] / 1e9:.3f} GB)")
        print(line, flush=True)
    torch.cuda.empty_cache()
    mark("1-3 (card, build, kernels)")

    # each path: its launch counts set to 0 just before it, read just after
    parity_phase(torch, args.seed)
    mark(4)
    # yi_6b: K2 once a layer in prefill, K1 (K1q) once a layer a step
    launches = {"static": static_slice(
        torch, args.seed, "yi_6b", "kernel",
        lambda n, steps: {"K2": n, "K1": n * steps})["launches"]}
    torch.cuda.empty_cache()
    mark(5)
    launches["continuous"] = continuous_phase(torch, args.seed)["launches"]
    torch.cuda.empty_cache()
    mark(6)
    launches["quant static"] = static_slice(
        torch, args.seed, "yi_6b", "kernel",
        lambda n, steps: {"K2": n, "K1q": n * steps},
        quant="fp8")["launches"]
    torch.cuda.empty_cache()
    launches["quant continuous"] = continuous_phase(
        torch, args.seed, quant="int8")["launches"]
    torch.cuda.empty_cache()
    mark(7)
    profile_phase(torch, args.seed)
    mark(8)
    rwkv_parity_phase(torch, args.seed)
    # rwkv6_3b: K7 once a layer in prefill, no attention kernel
    launches["rwkv"] = static_slice(
        torch, args.seed, "rwkv6_3b", "kernel",
        lambda n, steps: {"K7": n})["launches"]
    torch.cuda.empty_cache()
    profile_phase(torch, args.seed, arch="rwkv6_3b")
    mark(9)
    faithful_parity_phase(torch, args.seed)
    h2o_parity_phase(torch, args.seed)
    # yi_6b faithful: the token path in prefill and a token top-k a decode
    # step, no kernel at all
    launches["faithful"] = static_slice(
        torch, args.seed, "yi_6b", "faithful",
        lambda n, steps: {})["launches"]
    torch.cuda.empty_cache()
    profile_phase(torch, args.seed, dsa_mode="faithful")
    mark(10)
    # h2o: K2 with the 4096-token window once a layer in prefill; decode
    # attends the ring with no kernel (an SWA cache has no kt)
    launches["h2o"] = static_slice(
        torch, args.seed, "h2o_danube_1_8b", "kernel",
        lambda n, steps: {"K2": n}, prompt_len=8192)["launches"]
    torch.cuda.empty_cache()
    profile_phase(torch, args.seed, arch="h2o_danube_1_8b", prompt_len=8192)
    mark(11)
    # training: the plain model path, no kernel; eval runs K2
    train_parity_phase(torch, args.seed)
    train_slice(torch, args.seed)
    torch.cuda.empty_cache()
    mark(12)
    # prefix reuse and per-request modes: K3/K4 (K3q/K4q) on the prefix
    # runs, K3/K4 on the kernel-mode requests of the mixed-mode runs
    prefix_modes_parity_phase(torch, args.seed, card)
    launches.update(prefix_modes_slice(torch, args.seed, card)["launches"])
    mark(13)
    # speculative decoding: K1 (K1q) once a layer per verified row
    t14 = time.monotonic()
    spec_parity_phase(torch, args.seed, card)
    launches["spec static"] = spec_slice(torch, args.seed, card)["launches"]
    cont = spec_continuous(torch, args.seed, card)
    launches["spec continuous"] = cont["spec 4"]["launches"]
    print(f"phase 14: {time.monotonic() - t14:.1f} s", flush=True)
    # the request lifecycle, faults and telemetry (15a gated parity, 15b
    # the full-width runs, 15c speculation with a failing proposer)
    t15 = time.monotonic()
    lifecycle_parity_phase(torch, args.seed, card)
    lifecycle_slice(torch, args.seed, card)
    print(f"phase 15: {time.monotonic() - t15:.1f} s", flush=True)
    # checkpoints, RWKV6 training, dots and yi_6b training (16a gated
    # parity, 16b checkpoints, 16c and 16d the full-width train slices;
    # K7 once a layer in 16c's eval step)
    t16 = time.monotonic()
    rwkv_train_parity_phase(torch, args.seed)
    checkpoint_phase(torch, args.seed)
    launches["rwkv eval"] = rwkv_train_slice(torch, args.seed)["launches"]
    yi16d = yi_train_slice(torch, args.seed)
    print(f"phase 16: {time.monotonic() - t16:.1f} s", flush=True)
    # mixtral_8x22b's mixture of experts (17a gated parity, 17b the
    # full-width serving slices, K2 once a layer in the static prefill;
    # 17c full-width training)
    t17 = time.monotonic()
    mixtral_parity_phase(torch, args.seed, card)
    launches["mixtral"] = mixtral_slice(torch, args.seed, card)["launches"]
    mix17c = mixtral_train_slice(torch, args.seed, card)
    print(f"phase 17: {time.monotonic() - t17:.1f} s", flush=True)
    # deepseek_v3's multi-head latent attention, dense prologue and 256
    # experts (18a gated parity; 18b-c the full-width serving slices,
    # which launch no kernel: MLA prefill is the plain block gather, its
    # decode the latent attention; 18d full-width training)
    t18 = time.monotonic()
    deepseek_parity_phase(torch, args.seed, card)
    launches["deepseek"] = deepseek_slice(torch, args.seed, card)["launches"]
    deepseek_train_slice(torch, args.seed, card)
    print(f"phase 18: {time.monotonic() - t18:.1f} s", flush=True)
    # jamba_1_5_large's Mamba hybrid and recurrent archs in the continuous
    # engine (19a gated parity; 19b-c the full-width jamba serving slices,
    # K2 once a prefill and K1 once a step; 19d rwkv6_3b continuous, K7
    # once a layer a prefill; 19e training)
    t19 = time.monotonic()
    jamba_parity_phase(torch, args.seed, card)
    jam = jamba_slice(torch, args.seed, card)
    launches["jamba static"] = jam["launches"]
    launches["jamba continuous"] = jam["continuous"]["launches"]
    launches["rwkv continuous"] = rwkv_continuous_slice(
        torch, args.seed, card)["launches"]
    jamba_train_slice(torch, args.seed, card)
    print(f"phase 19: {time.monotonic() - t19:.1f} s", flush=True)
    # whisper_small's encoder-decoder and llama_3_2_vision's gated
    # cross-attention (20a gated parity; 20b-c the full-size serving
    # slices, K2 once a decoder layer a prefill and K1 once a decoder
    # layer a step; 20d training with the second input)
    t20 = time.monotonic()
    xattn_parity_phase(torch, args.seed, card)
    launches["whisper static"] = whisper_slice(
        torch, args.seed, card)["launches"]
    vis = vision_slice(torch, args.seed, card)
    launches["vision static"] = vis["launches"]
    launches["vision continuous"] = vis["continuous"]["launches"]
    xattn_train_slice(torch, args.seed, card)
    print(f"phase 20: {time.monotonic() - t20:.1f} s", flush=True)
    # distributed serving: tp 2 and dp 2 as two gloo processes on the card
    # (21a-b; 21b at full width, K2 once a layer a prefill and K1 once a
    # layer a step on each rank's 16 heads), NCCL at world size 1 (21c)
    launches["yi tp 2"] = distributed_phase(torch, args.seed)["launches"]
    # sharded training: FSDP and TP + SP as two gloo processes on the card
    # (22a-b; 22b against 16d's unsharded losses), NCCL at world size 1
    # (22c); no kernel launches (training takes the block path)
    distributed_train_phase(torch, args.seed, yi16d)
    # expert-parallel MoE training: mixtral_8x22b at full width, EP 2 x TP
    # 2 + SP as two gloo processes on the card (23a gated against the
    # unsharded run and the budget, 23b launch.train at 2 layers bf16);
    # no kernel launches (training takes the block path)
    ep_train_phase(torch, args.seed, mix17c)
    # the dry run's count against 16d's and 17c's measured steps (24a) and
    # yi_6b's one rank at tp 16 on the card (24b: K2 once a layer a
    # prefill, K1 once a layer a step, at G 2 on one KV head)
    launches["yi tp 16 rank"] = dryrun_phase(torch, args.seed, yi16d,
                                             mix17c)["launches"]
    # tensor parallelism for cross-attention and RWKV6: whisper_small,
    # llama_3_2_vision and rwkv6_3b at tp 2 as two gloo processes on the
    # card (25a-c: K2 once a decoder layer a prefill and K1 once a decoder
    # layer a step on each rank's heads, K7 once a layer a prefill on its
    # 20 heads), TP 2 + SP training (25d, no kernel: the block path is off);
    # its two ranks run phase 26 first, reported after it
    gc.collect()
    torch.cuda.empty_cache()
    ranks = tp_ranks(args.seed)
    xtp = xtp_phase(ranks)
    launches["whisper tp 2"] = xtp["whisper_small"]
    launches["vision tp 2"] = xtp["llama_3_2_vision"]
    launches["rwkv tp 2"] = xtp["rwkv6_3b"]
    # tensor parallelism for Mamba, MLA and the shared experts: jamba at 5
    # sub-blocks and deepseek's prologue + 1 MoE layer at tp 2 as two gloo
    # processes on the card (26a: K2 once a prefill and K1 once a step on
    # each rank's 32 heads over 4 KV heads; 26b: no kernel), TP 2 + SP
    # training, and deepseek's MoE layer under EP 2 x TP 2 + SP
    launches["jamba tp 2"] = mtp_phase(ranks)

    src = "src/repro_torch/kernels/csrc/"
    rep = "src/repro/kernels/"
    # no model path runs K5 or K5q (the staging caches are dense): their
    # launches are the sum of their counts over the four path runs
    paths = {k: sum(n.get(k, 0) for n in launches.values())
             for k in ("K5", "K5q")}
    # K1 runs on three main paths: the static slice, and the speculative
    # static and continuous slices (each path's count read right after its
    # own reset); its launches are their sum, each also given alone
    k1_paths = {p: launches[p]["K1"]
                for p in ("static", "spec static", "spec continuous")}
    kernels = []
    for name, cu, tpu, c, extra, n in (
            ("dsa_block_sparse_attention", "dsa_attention.cu",
             "dsa_attention.py:77", k2_checks[2], k2_checks,
             launches["static"]["K2"]),
            # K2's sliding-window path at h2o_danube_1_8b's prefill
            ("dsa_block_sparse_attention (window)", "dsa_attention.cu",
             "dsa_attention.py:77", k2w_checks[-1], k2w_checks,
             launches["h2o"]["K2"]),
            # and at mixtral_8x22b's (hd 128, G 6), the 17b static prefill
            ("dsa_block_sparse_attention (window, mixtral)",
             "dsa_attention.cu", "dsa_attention.py:77", k2m_checks[-1],
             k2m_checks, launches["mixtral"]["K2"]),
            ("dsa_decode_gather_attention", "dsa_decode.cu",
             "dsa_decode.py:185", k1_checks[2], k1_checks,
             sum(k1_paths.values())),
            ("dsa_chunk_gather_attention", "dsa_chunk_prefill.cu",
             "dsa_chunk_prefill.py:198", k3_checks[1], k3_checks,
             launches["continuous"]["K3"]),
            ("dsa_decode_paged_gather_attention", "dsa_decode.cu",
             "dsa_decode.py:116", k4_checks[-1], k4_checks,
             launches["continuous"]["K4"]),
            ("dsa_chunk_paged_gather_attention", "dsa_chunk_prefill.cu",
             "dsa_chunk_prefill.py:126", q_checks["K5", None][1],
             q_checks["K5", None], paths["K5"]),
            # K1q on the fp8 static slice, K3q/K4q on the int8 continuous one
            ("dsa_decode_gather_attention_quant", "dsa_decode.cu",
             "dsa_decode.py:90", q_checks["K1q", "fp8"][1],
             q_checks["K1q", "int8"] + q_checks["K1q", "fp8"],
             launches["quant static"]["K1q"]),
            ("dsa_decode_paged_gather_attention_quant", "dsa_decode.cu",
             "dsa_decode.py:108", q_checks["K4q", "int8"][1],
             q_checks["K4q", "int8"] + q_checks["K4q", "fp8"],
             launches["quant continuous"]["K4q"]),
            ("dsa_chunk_gather_attention_quant", "dsa_chunk_prefill.cu",
             "dsa_chunk_prefill.py:98", q_checks["K3q", "int8"][1],
             q_checks["K3q", "int8"] + q_checks["K3q", "fp8"],
             launches["quant continuous"]["K3q"]),
            ("dsa_chunk_paged_gather_attention_quant",
             "dsa_chunk_prefill.cu", "dsa_chunk_prefill.py:117",
             q_checks["K5q", "int8"][1],
             q_checks["K5q", "int8"] + q_checks["K5q", "fp8"],
             paths["K5q"])):
        kernels.append({
            "name": name, "route": "cuda", "source": src + cu,
            "replaces": rep + tpu, "launches": n,
            "max_abs_err": c["max_abs_err"],
            "ms": c["ms"], "kernel_ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["library_ms"], "host_us": c["host_us"],
            "geometry": c["geometry"],
            "checks": [{k: x[k] for k in ("geometry", "max_abs_err", "tol",
                                          "tol_used")}
                       for x in extra]})
    next(x for x in kernels if x["name"] == "dsa_decode_gather_attention")[
        "launches_by_path"] = k1_paths
    # jamba_1_5_large's attention layer: K2 in its static and continuous
    # prefills, K1 in their decode steps; likewise whisper_small's decoder
    # (static) and llama_3_2_vision's (static and continuous); each
    # entry's timed check is its main path's shape
    jam = ("jamba static", "jamba continuous")
    vis_paths = ("vision static", "vision continuous")
    for name, cu, tpu, checks, k, paths in (
            ("dsa_block_sparse_attention (jamba)", "dsa_attention.cu",
             "dsa_attention.py:77", k2j_checks, "K2", jam),
            ("dsa_decode_gather_attention (jamba)", "dsa_decode.cu",
             "dsa_decode.py:185", k1j_checks, "K1", jam),
            ("dsa_block_sparse_attention (whisper)", "dsa_attention.cu",
             "dsa_attention.py:77", k2x_checks, "K2", ("whisper static",)),
            ("dsa_decode_gather_attention (whisper)", "dsa_decode.cu",
             "dsa_decode.py:185", k1x_checks, "K1", ("whisper static",)),
            ("dsa_block_sparse_attention (llama vision)", "dsa_attention.cu",
             "dsa_attention.py:77", k2v_checks, "K2", vis_paths),
            ("dsa_decode_gather_attention (llama vision)", "dsa_decode.cu",
             "dsa_decode.py:185", k1v_checks, "K1", vis_paths),
            # yi_6b at tp 2: one rank's launches in phase 21b
            ("dsa_block_sparse_attention (yi tp 2)", "dsa_attention.cu",
             "dsa_attention.py:77", k2t_checks, "K2", ("yi tp 2",)),
            ("dsa_decode_gather_attention (yi tp 2)", "dsa_decode.cu",
             "dsa_decode.py:185", k1t_checks, "K1", ("yi tp 2",)),
            # yi_6b's one rank at tp 16: phase 24b's launches
            ("dsa_block_sparse_attention (yi tp 16 rank)",
             "dsa_attention.cu", "dsa_attention.py:77", k2t16_checks, "K2",
             ("yi tp 16 rank",)),
            ("dsa_decode_gather_attention (yi tp 16 rank)", "dsa_decode.cu",
             "dsa_decode.py:185", k1t16_checks, "K1", ("yi tp 16 rank",)),
            # phase 25's tp-2 ranks, rank 0's launches
            ("dsa_block_sparse_attention (whisper tp 2)", "dsa_attention.cu",
             "dsa_attention.py:77", k2xt_checks, "K2", ("whisper tp 2",)),
            ("dsa_decode_gather_attention (whisper tp 2)", "dsa_decode.cu",
             "dsa_decode.py:185", k1xt_checks, "K1", ("whisper tp 2",)),
            ("dsa_block_sparse_attention (llama tp 2)", "dsa_attention.cu",
             "dsa_attention.py:77", k2vt_checks, "K2", ("vision tp 2",)),
            ("dsa_decode_gather_attention (llama tp 2)", "dsa_decode.cu",
             "dsa_decode.py:185", k1vt_checks, "K1", ("vision tp 2",)),
            # phase 26a's tp-2 rank of jamba, rank 0's launches
            ("dsa_block_sparse_attention (jamba tp 2)", "dsa_attention.cu",
             "dsa_attention.py:77", k2jt_checks, "K2", ("jamba tp 2",)),
            ("dsa_decode_gather_attention (jamba tp 2)", "dsa_decode.cu",
             "dsa_decode.py:185", k1jt_checks, "K1", ("jamba tp 2",))):
        c = next(x for x in checks if "ms" in x)
        by_path = {p: launches[p].get(k, 0) for p in paths}
        kernels.append({
            "name": name, "route": "cuda", "source": src + cu,
            "replaces": rep + tpu, "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": c["max_abs_err"],
            "ms": c["ms"], "kernel_ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["library_ms"], "host_us": c["host_us"],
            "geometry": c["geometry"],
            "checks": [{k2: x[k2] for k2 in ("geometry", "max_abs_err",
                                             "tol", "tol_used")}
                       for x in checks]})
    c = k7_checks[2]
    # K7 runs on three main paths: rwkv6_3b's prefill, its eval step and
    # its continuous engine's admissions
    k7_paths = {p: launches[p].get("K7", 0)
                for p in ("rwkv", "rwkv eval", "rwkv continuous")}
    kernels.append({
        "name": "wkv6_chunked", "route": "cuda", "source": src + "wkv6.cu",
        "replaces": rep + "wkv6.py:75", "launches": sum(k7_paths.values()),
        "launches_by_path": k7_paths,
        "max_abs_err": c["max_abs_err"],
        "ms": c["ms"], "kernel_ms": c["ms"], "plain_ms": c["plain_ms"],
        "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
        "library_ms": None, "host_us": c["host_us"],
        "geometry": c["geometry"],
        "checks": [{k: x[k] for k in ("geometry", "max_abs_err", "tol",
                                      "tol_used", "parts")}
                   for x in k7_checks]})
    c = k7t_checks[0]
    kernels.append({
        "name": "wkv6_chunked (rwkv tp 2 rank)", "route": "cuda",
        "source": src + "wkv6.cu", "replaces": rep + "wkv6.py:75",
        "launches": launches["rwkv tp 2"].get("K7", 0),
        "launches_by_path": {"rwkv tp 2": launches["rwkv tp 2"].get("K7",
                                                                    0)},
        "max_abs_err": c["max_abs_err"],
        "ms": c["ms"], "kernel_ms": c["ms"], "plain_ms": c["plain_ms"],
        "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
        "library_ms": None, "host_us": c["host_us"],
        "geometry": c["geometry"],
        "checks": [{k: x[k] for k in ("geometry", "max_abs_err", "tol",
                                      "tol_used", "parts")}
                   for x in k7t_checks]})
    print(json.dumps({"kernels": kernels}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    t0 = time.monotonic()
    main()
    print(f"chip_smoke: done in {time.monotonic() - t0:.1f} s",
          file=sys.stderr)
