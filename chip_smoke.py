#!/usr/bin/env python3
"""Drive paddle_tpu_torch's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --eager-ab TREE [TREE ...]    # `eager_ab`

Phases, each printing one JSON line:

1. device  — the card's name, plus ``nvidia-smi --query-gpu=name,power.limit
   --format=csv,noheader`` printed as it comes (a line of its own).
2. build   — nvcc builds every CUDA kernel of the port from csrc/ (all
   sources in parallel), with its seconds and, from ``-Xptxas -v``, each
   kernel's registers and spilled bytes (``ptxas``). The bf16 and wide
   flash sources (LATE_SOURCES, the longest to compile) finish in the
   background until phase 13 first runs them: a ``build_late`` line
   there gives their seconds, the wait and their report.
3. kernel  — each kernel's wrapper on the card at the shapes the decode
   engine gives it, held against its plain PyTorch version on the same
   inputs (max abs error within a stated tolerance). ``ms``, ``plain_ms``
   and ``library_ms`` (one PyTorch library call computing the same function,
   timed only: the port never calls it) are device times, from CUDA events
   around replays of a CUDA graph of 20 calls (the gather's over rotating
   id sets and outputs, three L2 caches of them: its operands fit in L2);
   ``eager_ms`` is the wrapper's back-to-back eager rate, host overhead
   included. A kernel whose time reads under its bound fails the phase,
   here and in every later kernel phase. The FFN and
   flash forward must give the same bits on a second call, and the FFN's
   row 0 at M 8 must not move when the other rows change (the engine's
   bitwise concurrent = sequential contract); an ``ffn_routes`` line per M
   in 8, 16, 32 times the FFN through each of its two routes.
4. engine  — the full-width flagship LM (V 32000, d 512, 8 heads, 6 layers,
   d_ff 2048; random weights from a seed) behind GenerateEngine, whose
   fixed signatures run as CUDA graphs: warmup binds and captures 2 + 2 x
   buckets of them (the step and each bucket's prefill, greedy and
   sampled); 16 concurrent requests (prompts of 5..256 tokens, 32 new
   tokens, half greedy and half sampled with pinned seeds), every request
   equal to its own generate_once, no capture after warmup, every kernel's
   launch count risen by the traffic's replays, each signature's replay
   equal to its eager function (the model's own methods) at one cache
   state and one set of feeds (bitwise, or the logits within 1e-6 of the
   largest and a differing token only at a tie), the card's logits within
   tolerance of the plain-PyTorch path on the CPU, and tokens/s, the
   launches a replay runs, and the host ms of the step and each bucket's
   prefill to the read of the result, graphed and eager at the same feeds
   (with each replay's device time), beside the step's memory floor, and
   a torch.profiler breakdown of both (device busy share, the kernels
   taking the most device time), tagged with the card.
4b. engine_paged — the same LM behind the paged GenerateEngine
   (``paged=True``, block_size 16, slots 16 on 256 blocks: phase 4's HBM
   for K and V), after the gather, LN and FFN wrappers are held against
   their plain versions at its step's 16 rows (``kernel`` lines, as in
   phase 3). 24 concurrent requests, 32 new tokens each, half greedy and
   half sampled with pinned seeds: 12 prompts of one 192-token prefix (12
   full blocks) and distinct 8..60-token suffixes, 4 prompts of that
   prefix alone (copy-on-write), 4 of 300..470 tokens (two prefill
   chunks) and 4 of 5..40. Checks: phase 4's graph checks; every request
   equals its own paged generate_once, and each greedy one a contiguous
   engine's generate_once (phase 4's, or one whose ladder holds a 512
   bucket for the long prompts), where a token may differ only at a tie
   (at the first divergent step the two tokens' logits in the reference
   run within 1e-5: a prefix hit, a chunk or a bucket changes the
   products' shapes and so their bits; each tie is printed and nothing
   after it compared); prefix hits >= 15, copy-on-write copies >= 4 and
   the tokens saved those hits' cached lengths; ``peak_active`` above
   phase 4's 8 slots; no block in use after ``stop()``; the gather, LN
   and FFN kernels launched; one paged prefill, one with a prefix hit and
   one paged step within 1e-3 of the CPU's logits. Reports tokens/s, the
   host ms of a suffix prefill after the 192-token prefix in each bucket
   and of the paged step at 16 slots, graphed and eager, beside an eager
   contiguous step at the same 16 slots (replay device times; wall and
   device by torch.profiler) with each one's byte floor, ``stats()`` and
   peak memory, tagged with the card.
4c. engine_spec — speculative decoding on phase 4b's engine (``spec_k``
   4), after the gather, LN and FFN wrappers are held against their plain
   versions at the verify step's 80 rows. Phase 4b's 24 prompts, all
   greedy, through (a) a draft with the target's own weights (aliased; a
   draft pool of 513 blocks), (b) a layer-skip draft (``LMConfig(n_layer=
   1)`` over the target's ``tok_emb.w``, ``layer_0.*``, ``final_ln.*`` and
   ``lm_head.w``, aliased), then (a) again with every sixth request
   sampled for 8 tokens (fallback steps, then resyncs of stale draft
   caches), and a plain paged engine on the same weights. Checks: each
   engine's warmup captures its signatures (the plain ones, the drafter,
   the verify step and (b)'s draft prefills) and none after the traffic;
   each signature's replay (drafter and verify included) equal to its
   eager function as in phase 4; every token equal to the plain engine's
   generate_once (a sampled one to its own engine's) but at a tie
   (``engine_spec_tie`` lines); (a) accepts >= 95% of its proposals, each
   one it turned down printed with the target's logit gap
   (``engine_spec_lost``); after every run the target pool holds only the
   prefix cache's blocks, and after ``stop()`` no block of either pool is
   in use; the fallback run counts fallbacks and a resync; one full-width
   verify step within 1e-3 of the CPU's logits and of the card's one-token
   step at each of its rows; the gather, LN and FFN kernels launched by
   the speculative traffic. Reports each run's tokens/s, rounds, accept
   rate, tokens a round and host ms a round (draft and verify legs), one
   round's host ms graphed and eager for each draft beside the plain
   step, each graph's replay device time, torch.profiler breakdowns, the
   launches a replay runs, and peak memory, tagged with the card.

5. train_kernel — the training slice's kernels (CE forward and backward,
   the LN-residual backward, multi-tensor Adam) at the shapes the flagship's
   training step gives them (N 8192 rows of V 32000 logits, N 8192 rows of
   D 512, the LM's 76 parameter tensors), each against its plain version,
   timed as in phase 3 (with fewer calls per graph: these are 1 GB passes).
   The CE backward is held by each element's relative error and Adam by
   each state tensor's (``checked``): their values are far below any
   useful absolute limit.
6. train_vs_cpu — one full-width training forward and backward
   (LMConfig(dropout=0, use_flash_attention=False), B 2, L 512, one set of
   weights) on the card and on the CPU: the loss within 1e-4 absolute and
   every gradient within 1e-3 of that gradient's largest magnitude.
7. train     — the flagship training step as a user runs it:
   ``TransformerLM.loss`` (LMConfig() defaults: dropout 0.1, attention
   dropout 0.1, so attention is the unfused branch) and ``TensorAdam(1e-4,
   fuse=True).minimize`` for 20 steps on one fixed batch (B 16, L 512)
   with a seeded generator: the loss finite and fallen by step 20, every
   kernel of that path launched in this phase, step ms, tokens/s, peak
   device memory and a torch.profiler breakdown of one step.
8. flash_kernel — the flash forward (with its LSE), the dQ kernel and the
   dK/dV kernel against their plain versions at (a) the LM training shape,
   BH 128 (B 16 x 8 heads), L 512, dh 64, causal, no bias, and (b) BERT's,
   BH 1536 (B 128 x 12 heads), L 128, dh 64, not causal, with a key-padding
   bias from key lengths drawn in 32..128 and one batch element wholly
   padded, for which O, dQ, dK and dV must be exactly 0, and (c)
   ``lm_dh256``'s (phase 22), BH 128 (B 32 x 4 heads), L 512, dh 256,
   causal: the kernels' form that splits each head's output columns over
   two blocks. O and LSE within
   1e-4 absolute (LSE on the rows that keep a key); each gradient within
   1e-4 of that tensor's largest magnitude; two calls of each kernel give
   the same bits. Each case names the instantiation its launch takes and
   that instantiation's registers and spilled bytes; no dh-256
   instantiation of any flash kernel may spill. ``library_ms`` is
   ``F.scaled_dot_product_attention`` and
   its backward through autograd (one call that yields dQ, dK and dV
   together), timed only: the backward's device time from CUDA-graph
   replays like the kernels', and ``library_eager_ms`` its eager rate.
   ``bound_ms`` counts the visible (query, key) pairs of this run's mask:
   4 dh flops a pair forward, 6 dh for dQ, 8 dh for dK/dV; at dh 256
   ``bound_split_ms`` counts beside them the products that the column
   split repeats (``split_extra_flops``: 2 dh a pair forward, 4 dh for dQ
   and the bf16 dK/dV, 8 dh for the float32 dK/dV, whose dK and dV halves
   are blocks of their own).
9. flash_train_vs_cpu — phase 6 with flash attention on: the card against
   the CPU, and on the card flash against the unfused branch of phase 6,
   same limits.
10. train_flash — phase 7 in the configuration the repo's bench trains
   (attention dropout 0, flash attention on) but in float32 (phase 15 runs
   its ``amp=True``): all ten kernels of that path launched (the seven of
   phase 7 and the flash forward, dQ and dK/dV), step ms and tokens/s
   beside phase 7's.
10b. program_train — the Fluid front end on the card: ``build_lm`` +
   ``optimizer.Adam(1e-4, fuse=True).minimize``, the startup program and
   ``Executor().run(main, feed, fetch_list)`` (no place: cuda:0), at phase
   10's shape and batch (B 16 x L 512). (a) Flash on, dropout and
   attention dropout 0: the startup scope's parameters overwritten by name
   with a ``TransformerLM`` + ``TensorAdam`` run's initial weights, 10
   steps of each; the Executor's loss within 1e-4 relative of that run's
   at every step, every parameter within 1e-3 of its largest magnitude
   after the 10 steps (the K slice of each ``*.attn.qkv.b``, whose true
   gradient is 0, within 10 x lr), and each step launching exactly the
   path's kernels (gather 1, LN forward and backward 13, flash forward, dQ
   and dK/dV 6, FFN 6, CE forward and backward 1, Adam 1). (b) The bench's
   configuration (dropout 0.1, attention dropout 0), 10 steps on phase 10's
   weights: the loss finite and fallen, the same launches, step ms (host
   clock, no fetch read until the last step, as phase 10 times it; and
   with the loss read each step), device ms and peak memory beside phase
   10's, and the host ms an Executor step and a ``TransformerLM`` step take
   to return (the interpreter's cost); (f) ``program_train_bound``: (b)'s
   configuration through ``Executor.bind`` (one CUDA graph of the run
   plan a step), 10 bound calls on a copy of the starting scope held to
   10 eager ``run()`` steps of a fresh build and Executor (same seeds and
   run counters) within 1e-4 relative (loss) and 1e-3 of each parameter's
   largest magnitude (the K bias within 10 x lr), the share of bitwise
   equal losses, each call launching exactly one step's kernels, one
   capture (at ``bind``) and none after; the bound step's wall ms, the
   replay's device ms (CUDA events), host ms to return, tokens/s and peak
   memory beside (b)'s; (g) dropout 0.1 on a fed [64, 1024] tensor, its
   mask fetched: each bound call's mask equals ``run()``'s at the same run
   index bitwise, consecutive calls draw different masks. (c)
   ``LMConfig()`` (the unfused
   branch, the causal mask an ``assign_value``), 5 steps: the loss finite
   and fallen, the seven kernels of phase 7's path launched and no flash
   kernel, step ms. (d) ``build_lm(cfg, is_test=True)`` at B 8: its logits
   within 1e-4 of the largest magnitude of ``TransformerLM.logits`` on the
   same weights. (e) The README's quick start (fc, square_error_cost,
   ``SGD(0.01)``): the loss falls over 20 steps.
11. bert_kernel — the kernels of phases 3 and 5 at BERT-base's shapes (rows
   of D 768, the FFN at 768 -> 3072 -> 768 at N 4096 and, as the B 128
   forward calls it, at N 16384, CE at V 30522 and at V 2,
   gathers from the [30522, 768] and [2, 768] tables, Adam over 160
   tensors), each against its plain version.
12. bert      — BERT-base at full width (12 layers, d 768, 12 heads, d_ff
   3072, V 30522, L 128, 20 masked positions; random weights from a seed;
   batches from ``make_pretrain_batch`` with ``input_mask`` cut to lengths
   in 32..128, where the bench's batch has an all-ones mask under which the
   bias is all zeros and no key is dropped): the inference losses at B 4 on
   the card and on the CPU (total within 1e-4), flash against unfused on
   the card (rtol 1e-4), the forward at B 128 (ms, samples/s), and 10
   training steps at B 32 with attention dropout 0 so that the flash path
   trains (dropout 0.1, ``TensorAdam(1e-4, fuse=True)``, one fixed batch): the
   loss finite and fallen, all ten kernels launched, step ms, samples/s,
   peak memory and a profile of one step.
13. amp_flash_kernel — phase 8 on bf16 operands: the bf16 forward, dQ and
   dK/dV kernels against their plain versions at (a) the AMP LM step's
   shape, BH 512 (B 64 x 8 heads), L 512, dh 64, causal, (b) BERT's (as
   phase 8), (c) ``lm_long_seq8k``'s (bench.py:1124-1129), BH 16 (B 2 x
   8 heads), L 8192, dh 64, causal, and (d) ``lm_dh256``'s (as phase 8's
   (c)). O, dQ, dK and dV within 1e-2 of each
   tensor's largest magnitude, LSE within 1e-5 absolute on the rows that
   keep a key, the
   padded element exactly 0, two calls bitwise equal; ``library_ms`` is
   bf16 ``F.scaled_dot_product_attention`` and its backward; ``bound_ms``
   counts the products at the bf16 rate (989 TFLOP/s). The forward's
   cases name its plan (query rows a block and a warp, raw products or
   scaled scores), the registers and spilled bytes of the instantiation
   it launched (no instantiation of it may spill), ``ms_over_library``,
   the device kernels SDPA's call runs (``library_kernels``) and, without
   a mask, SDPA's FlashAttention-2 backend forced (``library_fa2_ms``,
   ``ms_over_fa2``): an mma.sync kernel, where SDPA's default on an H100
   is cuDNN's wgmma one. The dQ and dK/dV kernels' cases likewise name
   their plan (query rows or keys a block), the registers and spills of
   their instantiation (no instantiation of either may spill); the dK/dV
   cases also the device kernels of SDPA's backward and, without a mask,
   that backward with FA2 forced; ``pair_ms`` is dQ's time plus its own,
   and ``ms_over_library`` and ``ms_over_fa2`` hold that pair against
   SDPA's backward, which yields dQ, dK and dV.
13b. flash_head_widths — the three float32 and the three bf16 flash
   kernels at head widths 8, 48, 80, 96, 160, 192 and 256 (the wrappers
   zero-pad them to 16, 64, 128, 128, 256, 256; 256 itself runs as it
   is), B 4 x H 2, L 200, causal, a key-padding bias keeping 200, 173, 140
   and 101 keys: within phases 8's and 13's tolerances of their plain
   versions at the true width, one launch each a call; widths 257 and
   320 run through phase 13c's wide kernels (zero-padded to 384) under the
   same checks.
13c. wide_flash_kernel — the three wide flash kernels
   (``csrc/flash_attn_wide.cu``: head widths above 256, on the tensor
   cores; each block takes 16 rows and a group of up to four 128-wide
   column chunks of its outputs, its scores (and dP) once a tile for the
   group) at BH 64 (B
   32 x 2 heads), L 512, dh 512, causal, float32 and bf16, against their
   plain versions (float32: O and LSE 1e-4 absolute, each gradient 1e-4 of
   its largest magnitude; bf16: O, dQ, dK and dV 1e-2 of theirs, LSE
   1e-5), two calls bitwise equal, no spill in any of their
   instantiations; ``ms`` beside ``bound_ms`` (the ``bound`` rule: the
   products at the tensor-core rate) and ``bound_simt_ms`` (every flop at
   67 TFLOP/s), ``plain_ms``, and ``library_ms``: SDPA's call (its
   backward for dQ and dK/dV) under whichever backend takes dh 512, named
   by its device kernels (``library_kernels``). Then the ``flash_wide``
   path: ``build_lm`` at 2 heads of 512 (d 1024, L 512, d_ff 4096,
   ``lm_large``'s vocabulary, 2 layers, dropout 0) with ``Adam(1e-4,
   fuse=True)``, three ``run()`` steps at B 2 on the card against the CPU
   Executor from one initialization, float32 (``flash_wide``) and under
   ``mixed_precision.decorate`` (``flash_wide_amp``), at phase 22's hold
   limits, each card step launching exactly its path's kernels (the wide
   forward, dQ and dK/dV once a layer); then 5 timed steps of each (step
   ms, device ms, the wide kernels' device ms and share).
14. amp_train_vs_cpu — phase 9 with the model bf16-marked
   (``rewrite_model_bf16``): card against CPU, loss within 5e-3 relative
   and every gradient within 2e-2 of its largest magnitude; then the
   card's AMP step against phase 9's float32 one, reported without a
   limit.
15. train_amp — the bench's flagship row as it runs (bench.py:1058-1062:
   dropout 0.1, attention dropout 0, flash on, ``amp=True``): the model
   marked, ``decorate(TensorAdam(1e-4, fuse=True))``, B 64 x L 512, 20 steps on
   one fixed batch: the loss finite and fallen, every kernel of the AMP
   path launched (gather, LN forward and backward, CE forward and backward,
   Adam, the three bf16 flash kernels) and neither the FFN kernel nor the
   float32 flash kernels; step ms, tokens/s, peak memory and a profile of
   one step. Then the same at B 16 (``train_amp_b16``) beside phase 10.
16. bert_amp — BERT-base under AMP at the bench's B 128 (bench.py:1131):
   the inference forward beside phase 12's float32 one; 10 training steps
   with attention dropout 0 (the biased bf16 flash kernels train) under
   phase 15's checks; the bench's own configuration (attention dropout
   0.1: the unfused branch with bf16 matmuls), timed only.
15b. program_amp — the AMP program pass on the card: ``build_lm`` +
   ``mixed_precision.decorate(optimizer.Adam(1e-4, fuse=True)).minimize``
   + ``Executor().run``. (a) Flash on, dropout and attention dropout 0, B
   16: the startup scope's parameters overwritten with the initial weights
   of a ``TransformerLM`` + ``rewrite_model_bf16`` + ``decorate(TensorAdam)``
   run, 10 steps of each; the loss within 1e-4 relative of that run's at
   every step (and the share of bitwise-equal steps), every parameter
   within 1e-3 of its largest magnitude after 10 steps (the K slice of
   each ``*.attn.qkv.b`` within 10 x lr), and each step launching exactly
   the AMP path's kernels (gather 1, LN forward and backward 13, the bf16
   flash forward, dQ and dK/dV 6 each, CE forward and backward 1, Adam 1;
   no FFN and no float32 flash launch). (b) The bench's flagship row
   (dropout 0.1, attention dropout 0, B 64) and (c) the same at B 16, 10
   steps each on phase 15's weights: the loss finite and fallen, the same
   launches; step ms (host clock, as phase 15 times it), device ms and
   every CUDA launch a step (torch.profiler), tokens/s, model TFLOP/s
   (bench.py:58-67's formula), peak memory, and the host ms an Executor
   step and a model step take to return, beside phase 15's at the same
   batch. (d) ``lm_large`` (d 1024, 16 heads, 8 layers, d_ff 4096, B 32)
   and (e) ``lm_long_seq8k`` (L 8192, 4 layers, B 2), 5 steps each from the
   startup program's weights: the loss finite and fallen, the AMP path's
   launches exactly; step ms, tokens/s, model TFLOP/s, peak memory. (b),
   (d) and (e) then run as the bench runs them (``fused``): through
   ``Executor.run_fused`` over 4 batches stacked on the card, one first
   call, then 2 calls of 8 steps each timed with their own sync, the best
   over its steps (bench.py:70-120's method; its 120 steps a call and 2-3
   rounds cut), the loss finite, each replay launching exactly the path's
   kernels, one capture; step ms and tokens/s beside the eager step. (f)
   ``program_amp_bound``: (c) through ``Executor.bind`` as 10b (f), 20
   bound calls held to 20 eager steps, timed beside (c). Before
   them (``program_large_kernel``), phase 5's checks at ``lm_large``'s own
   shapes, but for the FFN, which its AMP step stands down: the gather
   from [32000, 1024], the LN-residual forward and backward at N 16384 x
   D 1024, CE at [16384, 32000] and Adam over its 166 M parameters.
   (``lm_long_seq8k``'s are phase 5's widths at half the rows.)
16b. program_bert — ``models.bert.build_bert_pretrain`` through the
   Executor on phase 12's weights and ``make_pretrain_batch`` batches with
   key lengths cut to 32..128. (a) The inference program at B 4: the total
   within 1e-5 relative of ``BertPretrain.loss(is_test=True)``. (b) The
   inference program at B 128: ms and samples/s beside phase 12's forward.
   (c) Training at B 32, dropout and attention dropout 0, 10 steps, held to
   ``BertPretrain`` + ``TensorAdam`` with 15b (a)'s limits, each step
   launching exactly gather 2, LN forward and backward 25, the flash
   forward, dQ and dK/dV 12 each, FFN 12, CE forward and backward 2, Adam
   1. (d) Under ``decorate`` at B 128, 10 steps each, in the bench's own
   configuration (attention dropout 0.1: the unfused branch, bf16
   ``matmul``s, no flash launch) and with attention dropout 0 (the biased
   bf16 flash kernels, 12 launches each a step): the loss finite and
   fallen, the launches exactly; step ms, device ms, samples/s and peak
   memory beside phase 16's; the bench's configuration then through
   ``run_fused`` as 15b (b) (``fused``), samples/s beside the eager step.

17. inference — the bench's inference benchmark (bench.py:623
   `_bench_inference`, rows bench.py:721-731) through the port's deploy
   path: build, run the startup program (seeded), `save_inference_model`
   into a temporary directory, `create_predictor` (the card) and one with
   ``place=CPUPlace()`` on the same artifact, then ``Predictor.run``. (a)
   ``bert_infer``: BERT-base, L 128, 20 masked positions, ``is_test``,
   float32, batches from ``make_pretrain_batch`` (seed 0). (b)
   ``resnet50_infer``: ``models.resnet.build('imagenet', depth=50)`` (3 x
   224 x 224, 1000 classes, built without ``is_test`` as the bench builds
   it: the export's clone puts its batch norms on the moving statistics),
   seeded float32 images, with ``torch.backends.cudnn.allow_tf32`` at
   torch's default (True) for the whole row: the conv lowering keeps
   float32 by itself, and must leave the flag as it found it. Checks, each
   failing the run: the card's B 2 outputs against the CPU predictor's
   (BERT's loss within 1e-4 relative; ResNet's softmax input, fetched by
   name through ``Executor.run`` of the pruned program, within 1e-4 of its
   largest magnitude, the probabilities within 1e-4); the predictor
   against ``Executor.run`` of the unpruned ``is_test`` program on the
   card (BERT bitwise; ResNet within 1e-5 of the largest magnitude, its
   ``bitwise`` printed); exact hand-written launches a call at B 1 and B
   128, predicted from the pruned program's op list (`infer_launches`:
   BERT the gather, LN forward, FFN, f32 flash forward and CE forward;
   ResNet none); every parameter on the card after the first call and the
   same tensor there after the last (no second upload); the
   ``run_fused`` window launching k x a call's kernels and capturing one
   graph. Prints per row the p50 ms of a call at B 1 and B 128 (9 rounds,
   5 for a feed above 8 MB, each call from numpy feeds to numpy fetches),
   ``machine_ms_b128`` (bench.py:566 `_machine_window`: ``run_fused`` over
   k 8 and k 40 steps on 8 batches staged on the card, best of 3, the
   slope), samples or images a second at B 128 (from the p50 and from
   ``machine_ms``), peak memory above what earlier phases hold, a
   torch.profiler breakdown of one B 128
   call (device busy share, top kernels and ops; ResNet's convolution
   share of device time) and the launches a call.

18. image_train — the bench's image training rows (bench.py:1130-1134,
   `_bench_image_model` bench.py:208-270) through the Fluid front end:
   ``resnet50`` (`models.resnet.build('imagenet', depth=50)`, lr 0.005)
   and ``se_resnext`` (`models.se_resnext.build()`, lr 0.02) on ImageNet
   3 x 224 x 224 images, 1000 classes, and ``vgg16``
   (`models.vgg.build(class_dim=10, image_shape=(3, 32, 32))`, lr 0.02) on
   CIFAR's, each at B 128 under ``decorate(Momentum(lr, 0.9),
   keep_bf16_activations=True)`` and ``minimize``, the startup program
   seeded; the bench's batches (rng ``RandomState(0)``, teacher labels from
   the 8 x 8-pooled images, k 4, 4 and 10 staged batches). Per row: (a)
   ``image_hold``: the row's model at B 4 on the card against the CPU
   Executor from the same startup state, every dropout at probability 0
   (the two generators draw different masks), with a float64 witness
   (`hold_image_to_cpu`; from this initialization the deep nets amplify
   each rounding of a step far past float32's limits): the float64 twin
   of the row's program two steps, every loss within 1e-9 and every
   parameter, velocity and statistic within 1e-8 of the CPU's; the
   float32 program one step, its loss within 1e-4 of the CPU's and each
   gradient no further from the float64 one than ``IMAGE_F32_RATIO``
   times the CPU's (or ``IMAGE_F32_FLOOR`` of the model's largest
   gradient element); the bench's keep-bf16 program one step, held so
   with ``IMAGE_AMP_RATIO`` and ``IMAGE_AMP_FLOOR``, its loss within
   5e-3 of the float64 loss or no further from it than that multiple of
   the CPU's; (b) two eager ``Executor.run`` steps: step ms, images/s,
   peak memory, zero hand-written launches, and a torch.profiler
   breakdown of one step (busy share, top kernels and ops, the
   convolutions' and the elementwise ops' shares of device time,
   `IMAGE_SHARES`); (c) the running statistics
   through a bound plan: K ``run()`` calls and one ``run_fused`` over the
   same K batches from the same state, under cuDNN's deterministic
   algorithms, every statistic, parameter and velocity bitwise equal
   (``fused_stats_equal_runs``); (d) ``run_fused`` as the bench times it,
   cut to a first call and 2 rounds of max(4, k) steps (the bench's 240
   steps a call and 2-3 rounds): step ms from the best round, images/s,
   peak memory, zero launches; the loss finite and fallen from the first
   eager step to the last fused one; and these rounds, under the flags
   they were timed with, against as many ``run()`` calls from the same
   state at the AMP limits (each call's loss 5e-3, the state 2e-2 of its
   largest magnitude over the model; ``fused_rounds_equal_runs``). The
   cuts: the rounds' length and count only; widths, batch, images and
   depth are the bench's.
18b. optimizer_checks — two programs on the card against the same
   program on the CPU Executor for three steps on one batch, at the f32
   limits (loss 1e-4 relative, every parameter within 1e-3 of its largest
   magnitude, the moving statistics too; an LM's K bias within 10 x lr, as
   10b holds it), under cuDNN's deterministic algorithms (`hold_steps`):
   (a) ``momentum_l2_decay``, the cifar10 ResNet of depth 8
   at B 32 under ``Momentum(0.05, 0.9, use_nesterov=True,
   regularization=L2Decay(1e-4))``; (b) ``resnet_keep_bf16``, the same
   net under ``decorate(Momentum(0.05, 0.9), keep_bf16_activations=True)``
   at the AMP limits (loss 5e-3 relative, the parameters and the moving
   statistics 2e-2 of their largest magnitude over the model); (c)
   ``lm_global_norm_clip``, the
   flagship LM at 2 layers (dropout 0, flash attention) at B 2 under
   ``set_gradient_clip(GradientClipByGlobalNorm(1.0))`` and ``Adam(1e-3,
   fuse=True)``: every f32 kernel of the training path under a clipped
   program, exactly phase 10b's launches a step.
19. stacked_lstm — ragged (LoD) sequences: the bench's ``stacked_lstm``
   row (bench.py:327-409, called at :1137) through the Fluid front end:
   word ids fed as ``(array, lod)``, the embedding (vocabulary 5000, width
   128), 3 x (fc to 512 + ``dynamic_lstm``, hidden 128),
   ``sequence_last_step``, a 2-way softmax fc, cross entropy and
   ``Adam(1e-3)`` (per-parameter ``adam`` ops). First the gather at the
   buckets' B 32 x L ids against its plain version
   (``stacked_lstm_kernel``). (a) ``stacked_lstm_hold``: the program, and
   a text classifier of ``dynamic_gru``, ``sequence_conv`` and
   ``sequence_pool(MAX)`` at the same widths, on a ragged B 4 batch
   (lengths drawn from 0..128, one empty) for three ``run()`` steps on
   the card against the CPU Executor at the f32 limits (loss 1e-4
   relative, every parameter and Adam moment within 1e-3 of its largest
   magnitude). (b) ``stacked_lstm_fused_mixed``: ``run_fused`` over four
   B 4 batches of two LoDs (A, A, B, A) against four ``run()`` calls at
   the same limits, one bound plan a LoD, each captured once (bitwise
   equality reported). (c) ``stacked_lstm_bucket`` and ``stacked_lstm``:
   B 32 at the bucket lengths 64, 96 and 128 as the bench builds its
   batches (one uniform LoD a bucket, labels from the words' mean score),
   each bucket 3 eager ``run()`` steps, one profiled eager step (device
   busy share, launches a step), then the bench's ``run_fused`` window on
   the batches staged on the card (one first call with its capture, then
   2 timed rounds of 16 steps: the bench's 30 steps cut), the step ms,
   samples/s and tokens/s of each bucket and blended over the three,
   exactly one gather launch a step and none of the other twelve forms,
   one capture a bucket, no host-to-device copy in two profiled fused
   steps, peak memory. Widths, batch, depth and buckets are the bench's.
20. ctr — sparse embedding gradients: the bench's two CTR rows
   (bench.py:510-551 `_bench_ctr`, called at :1135 and :1138) through the
   Fluid front end: 26 slots of ids, one ``is_sparse`` embedding (a
   SelectedRows gradient), fc 400 ReLU, fc 400 ReLU, fc 1 sigmoid,
   ``mean(log_loss)`` and ``Adagrad(0.01)`` at B 512, the startup program
   seeded; ``ctr_sparse`` at vocabulary 100000, width 16, and
   ``ctr_sharded_v1m`` at 1048576 x 32 with ``is_distributed=True`` (the
   plain lookup on one card, as the JAX package computes it without a
   mesh). First the gather at both rows' 512 x 26 ids against its plain
   version (tolerance 0), its device ms, bound and ``F.embedding``'s time
   (``ctr_kernel``). (a) ``ctr_hold``: each row's program at vocabulary
   1000 and B 64, three ``run()`` steps on the card against the CPU
   Executor from one initialization at the f32 limits (loss 1e-4
   relative, every parameter and Adagrad moment within 1e-3 of its
   largest magnitude). Then each row at its published widths: (b) five
   eager ``run()`` steps (step ms, samples/s, peak memory, exactly one
   gather launch a step and none of the other twelve forms) and one
   profiled eager step (busy share, launches, top kernels and ops); the
   table's and its moment's rows that no batch read bitwise as they were,
   the read ones moved; (c) ``run_fused`` over four batches against four
   ``run()`` calls from the same state, losses and state bitwise, one
   capture; (d) the bench's window: 150 distinct batches staged on the
   card and 150 steps a call (bench.py's ``max(150, k)`` for k 50 and
   20), a first call with its capture and then the bench's rounds (3 and
   2), the best round's step ms and samples/s, no host-to-device copy in
   two profiled fused steps, the loss falling from the first eager step
   to the last fused one. Nothing is cut.
22. lm_dh256 — the flagship LM family at head width 256: the bench's
   ``lm_large`` row (bench.py:1118-1122) with 4 heads in place of 16
   (V 32000, L 512, d 1024, 8 layers, d_ff 4096, dropout 0.1, attention
   dropout 0), weights from the startup program's seed, nothing cut. Its
   attention shape's kernels are phases 8 (c) and 13 (d). (a)
   ``lm_dh256_amp``: ``build_lm`` + ``mixed_precision.decorate(Adam)``
   through ``Executor.run`` at B 32, 5 steps (the loss finite and fallen,
   each step launching exactly the AMP path's kernels: the bf16 forward,
   dQ and dK/dV 8 each, at dh 256), then ``run_fused`` as 15b (b); step
   ms, tokens/s, model TFLOP/s, peak memory; and 2 layers at B 2 without
   dropout, three ``run()`` steps on the card against the CPU Executor at
   the AMP limits (loss 5e-3 relative, every parameter and moment within
   2e-2 of its group's largest magnitude: the parameters, the first
   moments, the second moments; the K slice of each qkv bias within 10 x
   lr; the parameters' change over the three steps, the K slices aside,
   as a whole: its norm within 2e-2 relative and its difference's norm
   within 0.1 of its norm, as an element whose gradient is within bf16's
   rounding of 0 may take the other sign of Adam's normalised update).
   (b) ``lm_dh256_f32``: the float32 flash program of
   the same configuration at B 4, 5 ``run()`` steps launching exactly the
   f32 path's kernels (the f32 flash forward, dQ and dK/dV and the FFN 8
   each), and 2 layers held to the CPU at the f32 limits (loss 1e-4
   relative, every tensor within 1e-3 of its own largest magnitude; the
   parameters' change, its norm and its difference's norm, within 1e-3).
   (c) ``lm_dh256_engine``: the contiguous ``GenerateEngine`` at the same
   configuration (dropout 0), 8 slots, max_len 512, buckets 128, 256 and
   512: 8 concurrent requests (prompts of 5..448 tokens, 32 new tokens,
   half greedy and half sampled with pinned seeds), each equal to its own
   ``generate_once``, no capture after warmup, the f32 flash forward
   launched by the prefills, and a 64-token prefill and one decode step
   within 1e-3 of the CPU's logits, as phase 4 holds the flagship's.

23. optest_replay — the repo's recorded op cases (``optest_cases/``, 480
   programs with their feeds, state and the JAX package's CPU fetches)
   replayed through ``Executor.run`` on the card by tools/torch_optest.py:
   every case whose op types the port registers and that draws nothing
   from JAX's key stream, each fetch within the corpus's rule,
   |got - cpu| <= loosen (1e-4 + 1e-3 |cpu|); one line a op type (cases
   run, worst normalised violation); any failing case fails the phase.

26. train_lm_example — the repo's training example, examples/train_lm.py,
   on the port call for call: ``build_lm`` at its configuration (the
   bench's flagship, bench.py:1058-1060: V 32000, L 512, d 512, 8 heads,
   6 layers, dropout 0.1, attention dropout 0, flash), the rate
   ``noam_decay(512, 400)`` (ops on the ``@LR_DECAY_COUNTER@`` step
   counter, computed on the card inside the step) and
   ``mixed_precision.decorate(Adam(learning_rate=lr))`` (76 plain
   ``adam`` ops, no fused Adam), at the example's B 64 with its 8 batches
   from ``RandomState(0)`` moved to the card once. First the kernels at
   this path's shapes (the gather, LN forward and backward at N 32768, CE
   at 32768 x 32000; the bf16 flash kernels' case is phase 13's LM case,
   this path's shape). (a) ``train_lm_example_hold``: the program at 2
   layers, B 2, dropout 0, 3 ``run()`` steps on the card against the CPU
   Executor at the AMP limits (phase 22's), the counter starting at 396 on
   both sides (steps 397-399: the rate 2.2e-3, near its warm-up peak, so
   that a wrong or ignored rate in the ``adam`` ops moves the parameters'
   change off the CPU's), the counters equal. (b) Step 1
   on a copy of the initial state through ``Executor.run``. (c) The
   example's loop: ``run_fused`` windows of 50 steps, one warm, then two
   timed (the best window's step ms, tokens/s), every replay of the timed
   windows launching exactly the path's kernels, one capture. (d) One
   profiled window of 10 steps: device ms a step, busy share, CUDA
   launches a step and no host-to-device copy. (e) One ``Executor.run``
   step timed eagerly. Checks: the rate at steps 1, 50, 100, 150 (and the
   later ones) within 1e-6 relative of noam's float64 closed form; the
   counter an int64 equal to the steps run; the loss finite and fallen
   from step 1 to step 150; and ``run_fused`` over 4 steps bitwise equal
   to 4 ``run()`` calls from one state (two builds with one seed: the
   dropout masks follow the program's counted stream), losses, rates,
   state and counter.
27. machine_translation — control flow: the bench's machine_translation
   row (bench.py:429-517, called at :1148) through the Fluid front end at
   its full width, nothing cut: ``build_nmt_train(Seq2SeqConfig())`` (V
   30000, embedding, encoder and decoder 512: a bi-LSTM encoder and a
   DynamicRNN decoder, a ``recurrent`` op whose step block attends over
   the ragged source with ``sequence_expand``, ``sequence_softmax`` and
   ``sequence_pool``) under ``Adam(1e-4)``, B 32 x L 30 in one LoD, and
   ``build_nmt_generate(Seq2SeqConfig(beam_size=3), max_len=50)`` (a
   ``While`` of 50 trips over ``top_k``, ``beam_search`` and tensor
   arrays, then ``beam_search_decode``). First the gather at the
   row's shapes (960 and 240 ids, and the 24 beam lanes a step, from the
   [30000, 512] table; ``nmt_kernel``). (a) ``nmt_hold``: the training
   program at V 1000, every width 64, on ragged B 4 batches (lengths 7,
   3, 5, 9) for three ``run()`` steps on the card against the CPU
   Executor at the f32 limits (loss 1e-4 relative, every parameter and
   Adam moment within 1e-3 of its largest magnitude; the parameters'
   change over the steps within 1e-3 of the CPU's in norm, its
   difference within 1e-3 of that norm: `hold_change`), and the generation
   program (beam 3, max_len 8) through ``run()`` on both: the beam ids
   equal (else the first difference and both sentences' scores are
   printed), the scores within 1e-4 relative. (b) ``nmt_train``: three
   eager ``run()`` steps on the 6 batches moved to the card once, each
   launching the gather twice; one profiled eager step (launches a step,
   device ms, busy share, the host ops taking the most host time). (c)
   ``run_fused`` windows of 6 steps (the bench's k): one that captures,
   two timed (the best window's step ms, tokens/s), every replay
   launching the gather twice, one capture, one profiled window (device
   ms a step, busy share) and two fused steps with no host-to-device
   copy. Checks: the loss finite and fallen from the first eager step to
   the last fused one; peak memory reported; one ``run_fused`` window of
   6 steps against 6 ``run()`` calls from one initialization, and 6 more
   ``run()`` calls against those, each pair bitwise (the last loss and
   every state tensor). (d) ``nmt_generate``: 8 source sentences of 30
   tokens through ``Executor.bind`` (one capture: the loop is one WHILE
   node of the graph, its trips run on the card), five timed calls (ms a
   call and a sentence), each launching the gather 51 times (the source
   and the loop's 50 trips, read back from its trip counter), a replay
   with no host-to-device copy, the replays equal to an eager ``run()``
   of the program on the card (its loop reading the condition on the
   host), bitwise.
28. decode_programs — the decode engine's Fluid programs
   (``models/transformer.py``: ``build_lm_prefill``,
   ``build_lm_decode_step``, ``build_lm_prefill_paged``,
   ``build_lm_drafter``, ``build_lm_verify``) bound through
   ``Executor.bind`` at phase 4's widths (the flagship ``LMConfig()``,
   dropout 0, flash on; 8 slots, max_len 512, buckets 64/128/256), on
   the weights of a phase-4 engine (seed 0) copied into a scope with
   zeroed caches. (a) Phase 4's 16 prompts served greedily through the
   contiguous programs from a loop of the phase's own (two waves of 8:
   each prompt prefilled into its slot by its bucket's program, then 31
   decode steps fed back on the card), each request's 32 tokens equal to
   the engine's ``generate_once`` (a token may part only at a tie of
   the program's logits, printed as a ``decode_program_tie`` line);
   one capture a signature, launches a replay exactly 1 gather, 12 LN
   and 6 FFN (a prefill 6 flash more), no host-to-device copy in a step
   or prefill replay, the scope's cache the same tensor throughout; the
   bound step's host ms (numpy feeds, one read) and replay device ms
   against the engine's graphed step at the same feeds, in turns. (b)
   The paged programs at phase 4b's pool (16 slots, 256 blocks of 16):
   the 16 prompts in one wave, each request's blocks cut from the pool
   in order, held to a paged engine of the same weights; then one
   speculative round (the drafter of the target's weights proposing
   SPEC_K tokens, the verify step over them): the accepted tokens equal
   the paged engine's continuation for each request whose tokens did not
   part at a tie; launches a replay exactly 1 gather, 12 LN and 6 FFN for
   a paged step, prefill and the verify step, and SPEC_K + 1 gathers,
   58 LN and 29 FFN for the drafter. Peak memory of each part reported.
29. observability — the port's monitor, trace, goodput, analysis and
   profiler on the main paths, after a reset of the monitor, goodput and
   trace (a snapshot before, which exports what the earlier phases'
   plans registered). (a) Phase 4's engine and 16 requests with
   ``metrics_port=0``:
   ``/metrics`` scraped after the requests drained (goodput drained
   first) equals ``monitor.export_prometheus()`` line for line but for
   the wall-clock gauges (``goodput_wall_seconds``, ``goodput_frac``,
   ``model_flops_per_s``); ``generate_request_total{outcome="ok"}`` is 16
   with no other outcome, ``decode_tokens_total`` the tokens the requests
   got, no capture after warmup, ``/healthz`` answers ``ok``, no request's
   trace stages sum past its latency (their share printed), the engine's
   kernels launched. (b) examples/train_lm.py's AMP program (phase 26's
   ``EXAMPLE_LM`` at B 64) through ``run_fused``: a first call of 2 steps
   (the eager step registers the plan's cost, then the capture), then
   OBS_WINDOWS windows of OBS_WINDOW steps in a fresh goodput window:
   the counted product flops a step equal `example_product_flops`, the
   closed form of analysis.py's rule for the config; ``step_mfu`` and
   ``hbm_bw_util_frac`` in (0, 1]; goodput counts every step; printed:
   ``goodput_frac``, ``step_mfu``, ``hbm_bw_util_frac``, the productive
   seconds beside the windows' CUDA-event device time, the busy share of
   the port's profiler over OBS_PROFILED more steps, and
   ``program_peak_bytes`` beside ``max_memory_allocated`` (the peak
   statistics reset before the plan's first step). (c) The bound decode
   step of (a)'s engine (8 slots), each call's host ms, with the hooks on
   and off (``PADDLE_PERFWATCH=0``, ``PADDLE_TRACE=0``) in OBS_HOOK_PAIRS
   pairs of calls: the rise of the median and its spread over the fifths
   of the pairs (`hook_cost`), beside the card's name and power limit.
30. training_health — the health and fault-tolerance tier on
   examples/train_lm.py's program (phase 26's ``EXAMPLE_LM``, AMP, B 64,
   ``noam_decay`` + ``decorate(Adam)``), seeded, with a float [1] feed
   (``POISON``) added to its loss: 0 on good steps, NaN on a poisoned one,
   with ``FLAGS_check_nan_inf`` and ``PADDLE_NAN_LOCALIZE=1`` on. (a)
   HEALTH_GOOD_STEPS good ``Executor.run`` steps through
   ``TrainingGuard(health='preempt')`` (the program instrumented by
   health.py), each launching exactly the example's kernels, with one
   poisoned step before good step HEALTH_POISON_AT: it is skipped, the
   state after it equals the state before it bitwise, and its
   localization names the added ``elementwise_add``. (b) The same good
   steps unguarded: the losses and every state tensor bitwise equal to
   the guarded run's, the run counters equal (dropout included). (c)
   Recorded: each step's ms, guarded and unguarded, the guard's snapshot
   bytes and ms, the peak memory a step over its base on each side. (d)
   One more instrumented step fetching its stat vector with the tensors
   it reduces: each entry equals ``torch.linalg.vector_norm`` of them
   within HEALTH_STAT_TOL relative (counts exact), every update ratio
   above 0. (e) ``training_health_hold``: at HEALTH_HOLD_LAYERS layers,
   dropout 0, B 2, the stat vectors of HEALTH_HOLD_STEPS steps on the card
   against the CPU Executor's at phase 15b's AMP limits. (f) ``run()`` and
   a ``run_fused`` window over a good, a poisoned and a good batch, and
   (g) a bound call on the poisoned batch, each raise naming the loss
   alone; (g) also times HEALTH_BOUND_CALLS bound calls with the check in
   the graph against as many without it, alternating (the check's ms a
   bound step). (h) ``PADDLE_FAULT_SPEC=run:n=2``: a guarded step retries
   to success, ``retry_attempt_total{site=run}`` +2, no give-up.

``bound_ms`` is the least time the card could take: the larger of the
bytes (each input read once, each output written once) over 3.35 TB/s and
the operations' time, where matrix-product flops (the FFN's two products,
the flash kernels' Q·K^T, P·V and gradient products) count at 165 TFLOP/s
(495 TFLOP/s TF32 over the 3xTF32 split's three passes: f32 accuracy on the
tensor cores), the bf16 kernels' products at 989 TFLOP/s, and other flops
at the f32 CUDA-core peak of 67 TFLOP/s.
Those four kernels also get ``bound_simt_ms``, every flop at 67 TFLOP/s,
the rule of the tables before the tensor-core kernels.
Every case of the embedding gather, in whichever phase times it (the
decode rows of 3, 4b and 4c, the training rows of 5, 11 and 15b (d),
phase 19's buckets, phase 20's rows and phase 27's shapes), also prints a
``gather_case``
line of its own: ``ms`` beside ``bound_ms``, ``share_of_bound`` and
``library_ms`` (``F.embedding``), with the path (``at``), n, D and the
table's rows.

Then a ``total`` line (the script's seconds, the card beside them) and
one line ``{"kernels": [...]}`` (per kernel: route, source, the TPU
kernel it replaces, launches on each path (the engine paths' counted
through their graphs' replays), max abs error, ms, plain_ms,
bound_ms and what bounds it, library_ms, at the shape of the first path
that runs it, with its cases at the other paths' shapes beside them), and
last ``{"ok": true, "device": {...}}``. Any
failure raises: the script exits non-zero and prints no last line. Without
a CUDA card, or without the rest of the repository beside it, it exits
non-zero at once.
"""
import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, f32
# throughput outside the tensor cores, and the f32-accurate tensor-core rate
# of the 3xTF32 split (495 TFLOP/s TF32, three passes a product)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32X3_FLOPS = 495e12 / 3
# bf16 tensor-core products with float32 accumulation (dense)
PEAK_BF16_FLOPS = 989e12
# the H100's L2 cache (hopper-kernels guide): a timed kernel whose operands
# fit in it runs over rotating buffers (`rotating_ms`)
L2_BYTES = 50 * 2 ** 20

SLOTS = 8
MAX_LEN = 512
BUCKETS = (64, 128, 256)
NEW_TOKENS = 32
N_REQUESTS = 16
# phase 4b: the paged engine at phase 4's K/V HBM (256 blocks of 16 rows =
# 8 slots of 512 rows) with twice its slots
PAGED_SLOTS = 16
PAGED_BLOCK = 16
PAGED_BLOCKS = SLOTS * MAX_LEN // PAGED_BLOCK
PAGED_PREFIX = 192
# token counts of the other prompts: the shared prompts' suffixes, the long
# prompts (two prefill chunks each) and the short ones, (least, most)
PAGED_SUFFIX = (8, 60)
PAGED_LONG = (300, 470)
PAGED_SHORT = (5, 40)
PAGED_KERNELS = ('embedding_gather', 'fused_ln_residual', 'fused_ffn')
# logits of two tokens this close are a tie (phase 4b's token comparisons)
TIE = 1e-5
# phase 4c: speculative decoding on phase 4b's engine, the reference's
# spec_k; the fallback run samples every sixth request, for 8 new tokens
# (the greedy ones then speculate again, on stale draft caches)
SPEC_K = 4
SPEC_SAMPLED_EVERY = 6
SPEC_SAMPLED_TOKENS = 8

# the kernels the decode engine launches
ENGINE_KERNELS = ('embedding_gather', 'fused_ln_residual', 'flash_attention',
                  'fused_ffn')
# the flagship training step: B 16 sequences of L 512 tokens
TRAIN_B = 16
TRAIN_STEPS = 20
# the kernels a training step launches with attention dropout on (build_lm
# then attends through the unfused branch) ...
TRAIN_KERNELS = ('embedding_gather', 'fused_ln_residual', 'fused_ffn',
                 'softmax_ce_fwd', 'softmax_ce_bwd', 'fused_ln_residual_bwd',
                 'fused_adam')
# ... and with attention dropout 0 and flash attention on, as BERT does too
FLASH_KERNELS = ('flash_attention', 'flash_attention_bwd_dq',
                 'flash_attention_bwd_dkv')
FLASH_TRAIN_KERNELS = TRAIN_KERNELS + FLASH_KERNELS
BERT_TRAIN_B = 32
BERT_INFER_B = 128
BERT_STEPS = 10
# the kernels each driven path must launch
# bf16 AMP training (the bench's amp=True): the flash kernels' bf16 form;
# the marked FFN runs no kernel (the JAX package's XLA tier)
AMP_FLASH_KERNELS = ('flash_attention_bf16', 'flash_attention_bf16_bwd_dq',
                     'flash_attention_bf16_bwd_dkv')
AMP_TRAIN_KERNELS = ('embedding_gather', 'fused_ln_residual',
                     'softmax_ce_fwd', 'softmax_ce_bwd',
                     'fused_ln_residual_bwd', 'fused_adam') + AMP_FLASH_KERNELS
# ... and must not launch
AMP_IDLE_KERNELS = ('fused_ffn',) + FLASH_KERNELS
AMP_TRAIN_B = 64            # bench.py:1062
AMP_BERT_B = 128            # bench.py:1131
# phase 10b: the Fluid front end's steps
PROGRAM_STEPS = 10
PROGRAM_DEFAULT_STEPS = 5
PROGRAM_INFER_B = 8
QUICK_START_STEPS = 20
# phase 15b: the bench's other AMP LM rows (bench.py:1118-1129), at their
# batches, through the Executor
LM_LARGE = dict(vocab_size=32000, seq_len=512, d_model=1024, n_head=16,
                n_layer=8, d_ff=4096, dropout=0.1, attn_dropout=0.0,
                use_flash_attention=True)
LM_LARGE_B = 32
SEQ8K = dict(vocab_size=32000, seq_len=8192, d_model=512, n_head=8,
             n_layer=4, d_ff=2048, dropout=0.0, attn_dropout=0.0,
             use_flash_attention=True)
SEQ8K_B = 2
LARGE_STEPS = 5
# phase 22: lm_large (bench.py:1118-1122) at head width 256 (4 heads of
# 256): AMP at lm_large's batch, float32 at B 4, the holds against the CPU
# at 2 layers and B 2 (3 steps), the engine at phase 4's slots and length
LM_DH256 = dict(LM_LARGE, n_head=4)
LM_DH256_B = 32
LM_DH256_F32_B = 4
DH256_HOLD_LAYERS, DH256_HOLD_B, DH256_HOLD_STEPS = 2, 2, 3
DH256_BUCKETS = (128, 256, 512)
DH256_REQUESTS = 8
# phase 13c: the wide flash kernels (head widths above 256) at BH 64 (B 32
# x 2 heads), L 512, dh 512, causal; and the flash_wide path, lm_large's
# width over 2 heads of 512 at 2 layers, held to the CPU at phase 22's
# batch and steps
WIDE_FLASH_KERNELS = ('flash_attention_wide', 'flash_attention_wide_bwd_dq',
                      'flash_attention_wide_bwd_dkv')
WIDE_SHAPE = dict(B=32, H=2, L=512, dh=512)
FLASH_WIDE = dict(LM_LARGE, n_head=2, n_layer=2, dropout=0.0)
# phase 15b (f): the bound AMP step's calls, held to as many eager steps
BOUND_STEPS = 20
# the run_fused rows: K batches staged on the card (bench.py stages its
# k_per_call), a first call and FUSED_ROUNDS timed calls of FUSED_STEPS
# steps each (the bench's 120 steps and 2-3 rounds, cut for time)
FUSED_K = 4
FUSED_STEPS = 8
FUSED_ROUNDS = 2
# phase 16b: BERT's inference batch at phase 12's (i)
BERT_CHECK_B = 4
# the bench's AMP BERT row attends through the unfused branch: no flash
AMP_BERT_UNFUSED_KERNELS = tuple(k for k in AMP_TRAIN_KERNELS
                                 if k not in AMP_FLASH_KERNELS)
# phase 17: the bench's inference benchmark (bench.py:623-731) through
# save_inference_model -> create_predictor -> Predictor.run: the batches it
# times, its rounds (fewer for a feed above 8 MB), the batch held to the
# CPU predictor, and the k of its differential run_fused window
INFER_BATCHES = (1, 128)
INFER_ROUNDS = 9
INFER_ROUNDS_LARGE = 5
INFER_CHECK_B = 2
INFER_WINDOW = (8, 40)
# the kernels BERT's inference call launches; ResNet-50's launches none
BERT_INFER_KERNELS = ('embedding_gather', 'fused_ln_residual',
                      'flash_attention', 'fused_ffn', 'softmax_ce_fwd')
# phase 18: the bench's image training rows (bench.py:1130-1134 through
# `_bench_image_model`, bench.py:208-270): (row, image shape, classes, lr,
# k staged batches); B 128 under decorate(Momentum, keep_bf16_activations)
IMAGE_B = 128
IMAGE_ROWS = (('resnet50', (3, 224, 224), 1000, 0.005, 4),
              ('se_resnext', (3, 224, 224), 1000, 0.02, 4),
              ('vgg16', (3, 32, 32), 10, 0.02, 10))
# eager Executor.run steps, then run_fused rounds of max(4, k) steps each
# (the bench's 240 steps a call and 2-3 rounds, cut for time: 3 eager
# steps and max(8, k) until the script took on phase 30)
IMAGE_EAGER_STEPS = 2
IMAGE_FUSED_STEPS = 4
IMAGE_FUSED_ROUNDS = 2
# the hold against the CPU Executor at B 4 (`hold_image_to_cpu`): how far
# (2-norm) the card's gradient of a tensor may lie from the float64 one,
# as a multiple of the CPU's distance, or as a share of the float64
# gradient's norm (`PERF.md` §6: the CPU's own distances, and ReLU kinks
# that the two sides cross at other elements)
IMAGE_CHECK_B = 4
IMAGE_F32_RATIO, IMAGE_F32_FLOOR = 4.0, 2e-3
IMAGE_AMP_RATIO, IMAGE_AMP_FLOOR = 4.0, 1e-3
# the host ops whose device time a row's step profile sums: cuDNN's
# convolutions, forward and backward, and the elementwise and reduction
# ops (batch norm's passes, the residual adds, the casts)
IMAGE_SHARES = {
    'conv': ('aten::cudnn_convolution', 'aten::convolution_backward'),
    'elementwise': ('aten::add', 'aten::add_', 'aten::sub', 'aten::rsub',
                    'aten::mul', 'aten::div', 'aten::neg', 'aten::sqrt',
                    'aten::pow', 'aten::mean', 'aten::sum', 'aten::copy_',
                    'aten::_to_copy')}
# phase 19: the bench's stacked_lstm row (bench.py:327-409, called at
# :1137): vocabulary 5000, embedding 128, hidden 128, 3 x (fc to 512 +
# dynamic_lstm), B 32 at the bucket lengths 64, 96 and 128, each bucket its
# own run_fused window; the bench's 30 steps a window and its rounds cut to
# LSTM_FUSED_STEPS and LSTM_FUSED_ROUNDS, nothing else cut
LSTM_VOCAB, LSTM_EMB, LSTM_HID, LSTM_LAYERS = 5000, 128, 128, 3
LSTM_B = 32
LSTM_BUCKETS = (64, 96, 128)
LSTM_EAGER_STEPS = 3
LSTM_FUSED_STEPS = 16
LSTM_FUSED_ROUNDS = 2
# the ragged holds against the CPU Executor: B 4, lengths from 0..128 with
# one empty sequence, one run() step a batch
LSTM_CHECK_B = 4
LSTM_CHECK_STEPS = 3
# phase 20: the bench's CTR rows (bench.py:510-551, called at :1135 and
# :1138), each (name, vocabulary, width, is_distributed, rounds); the
# bench's window stages max(150, k) = 150 batches and runs 150 steps a
# call for both rows' k (50, 20); nothing is cut
CTR_SLOTS, CTR_HIDDEN, CTR_B = 26, 400, 512
CTR_ROWS = (('ctr_sparse', 100000, 16, False, 3),
            ('ctr_sharded_v1m', 1 << 20, 32, True, 2))
CTR_WINDOW = 150
CTR_EAGER_STEPS = 5
# the holds against the CPU Executor at vocabulary 1000 and B 64, and
# run_fused over CTR_FUSED_K batches against as many run() calls
CTR_HOLD_V, CTR_HOLD_B, CTR_HOLD_STEPS = 1000, 64, 3
CTR_FUSED_K = 4
# phase 26: examples/train_lm.py (its LMConfig is bench.py:1058-1060's
# flagship; noam_decay(d_model, 400), decorate(Adam(learning_rate=lr)),
# B 64, 8 batches from RandomState(0), run_fused windows of 50 steps)
EXAMPLE_LM = dict(vocab_size=32000, seq_len=512, d_model=512, n_head=8,
                  n_layer=6, d_ff=2048, dropout=0.1, attn_dropout=0.0,
                  use_flash_attention=True)
EXAMPLE_B, EXAMPLE_K, EXAMPLE_WINDOW, EXAMPLE_WARMUP = 64, 8, 50, 400
EXAMPLE_TIMED = 2           # timed windows after the warm one
EXAMPLE_PROFILED = 10       # steps of the profiled window
EXAMPLE_BITWISE_STEPS = 4
COUNTER = '@LR_DECAY_COUNTER@'
# phase 29: observability. The AMP LM step in OBS_WINDOWS run_fused windows
# of OBS_WINDOW steps (one more profiled), then the bound decode step's
# host ms with the hooks on and off in OBS_HOOK_PAIRS pairs of calls
OBS_WINDOW, OBS_WINDOWS, OBS_PROFILED = 10, 2, 3
OBS_HOOK_PAIRS = 4000
# gauges read against the wall clock: two scrapes a moment apart differ
OBS_WALL_GAUGES = ('goodput_wall_seconds', 'goodput_frac',
                   'model_flops_per_s')
# phase 30: training health and fault tolerance. The example's program
# (EXAMPLE_LM, AMP, B 64) with a float [1] feed POISON added to its loss,
# seeded HEALTH_SEED: HEALTH_GOOD_STEPS good steps guarded, with one
# poisoned step before good step HEALTH_POISON_AT, and unguarded; the
# stats against the CPU at HEALTH_HOLD_LAYERS layers for HEALTH_HOLD_STEPS
# steps; HEALTH_BOUND_CALLS bound calls each with the check on and off
POISON = 'poison'
HEALTH_SEED = 30
HEALTH_GOOD_STEPS, HEALTH_POISON_AT = 12, 6
HEALTH_HOLD_LAYERS, HEALTH_HOLD_STEPS = 2, 2
HEALTH_BOUND_CALLS = 10
HEALTH_STAT_TOL = 1e-5
# where a held program's step counter starts (phase 26 (a))
EXAMPLE_HOLD_COUNTER0 = 396
# phase 27: the bench's machine_translation row (bench.py:429-517, called
# at :1148): Seq2SeqConfig() (V 30000, embedding, encoder and decoder 512),
# B 32 x L 30 in one shared LoD, Adam(1e-4), K 6 batches a run_fused
# window (the bench's k); beam-3 generation of 8 sentences of 30 tokens at
# max_len 50 through bind. Nothing is cut; the bench's rounds are
# NMT_FUSED_ROUNDS windows and GEN_ROUNDS calls
NMT_B, NMT_L, NMT_K = 32, 30, 6
NMT_EAGER_STEPS = 3
# the sources built in the background (phase 2)
LATE_SOURCES = ('flash_attn_bf16_fwd', 'flash_attn_bf16_bwd',
                'flash_attn_wide')
# --eager-ab: rounds of steps a tree
EAGER_AB_ROUNDS, EAGER_AB_STEPS = 16, 3
NMT_FUSED_ROUNDS = 2
GEN_B, GEN_BEAM, GEN_MAX_LEN, GEN_ROUNDS = 8, 3, 50, 5
# the holds against the CPU Executor: V 1000, every width 64, B 4 ragged,
# three run() steps; generation at beam 3, max_len 8 over the same source
NMT_HOLD_V, NMT_HOLD_W, NMT_HOLD_LENS, NMT_HOLD_STEPS = 1000, 64, \
    (7, 3, 5, 9), 3
NMT_HOLD_MAX_LEN = 8
# phase 28: the decode engine's programs bound at phase 4's sizes (8 slots,
# max_len 512, buckets 64/128/256, phase 4's 16 prompts, greedy, NEW_TOKENS
# each), the paged ones at phase 4b's pool (16 slots, blocks of 16, 256
# blocks) with one speculative round of SPEC_K drafts
PROGRAM_STEP_KERNELS = {'embedding_gather': 1, 'fused_ln_residual': 12,
                        'fused_ffn': 6}
PROGRAM_PREFILL_KERNELS = dict(PROGRAM_STEP_KERNELS, flash_attention=6)
# the paged prefill attends through kv_prefix_attention (plain torch); the
# drafter unrolls SPEC_K + 1 towers, the last of which stops at its last
# layer's cache write (no attention LN, no FFN there)
PROGRAM_PAGED_PREFILL_KERNELS = PROGRAM_STEP_KERNELS
PROGRAM_DRAFTER_KERNELS = {'embedding_gather': SPEC_K + 1,
                           'fused_ln_residual': 12 * (SPEC_K + 1) - 2,
                           'fused_ffn': 6 * (SPEC_K + 1) - 1}
DECODE_PROGRAM_KERNELS = ('embedding_gather', 'fused_ln_residual',
                          'fused_ffn', 'flash_attention')
# the AMP path's kernels but the fused Adam: the example's Adam is not
# fused, so it appends one ``adam`` op a parameter (plain torch)
EXAMPLE_KERNELS = tuple(k for k in AMP_TRAIN_KERNELS if k != 'fused_adam')
PATH_KERNELS = {'engine': ENGINE_KERNELS, 'engine_paged': PAGED_KERNELS,
                'engine_spec': PAGED_KERNELS,
                'train': TRAIN_KERNELS,
                'train_flash': FLASH_TRAIN_KERNELS,
                'program_held': FLASH_TRAIN_KERNELS,
                'program_train': FLASH_TRAIN_KERNELS,
                'program_default': TRAIN_KERNELS,
                'bert': FLASH_TRAIN_KERNELS, 'train_amp': AMP_TRAIN_KERNELS,
                'bert_amp': AMP_TRAIN_KERNELS,
                'program_amp': AMP_TRAIN_KERNELS,
                'program_large': AMP_TRAIN_KERNELS,
                'program_seq8k': AMP_TRAIN_KERNELS,
                'program_bert': FLASH_TRAIN_KERNELS,
                'program_bert_amp': AMP_TRAIN_KERNELS,
                'program_train_bound': FLASH_TRAIN_KERNELS,
                'program_amp_bound': AMP_TRAIN_KERNELS,
                'program_amp_fused': AMP_TRAIN_KERNELS,
                'program_large_fused': AMP_TRAIN_KERNELS,
                'program_seq8k_fused': AMP_TRAIN_KERNELS,
                'program_bert_fused': AMP_BERT_UNFUSED_KERNELS,
                'bert_infer': BERT_INFER_KERNELS, 'resnet50_infer': (),
                'resnet50_train': (), 'se_resnext_train': (),
                'vgg16_train': (), 'momentum_l2_decay': (),
                'resnet_keep_bf16': (),
                'lm_global_norm_clip': FLASH_TRAIN_KERNELS,
                'stacked_lstm': ('embedding_gather',),
                'stacked_lstm_hold': ('embedding_gather',),
                'gru_conv_max_pool_hold': ('embedding_gather',),
                'ctr_sparse': ('embedding_gather',),
                'ctr_sharded_v1m': ('embedding_gather',),
                'ctr_sparse_hold': ('embedding_gather',),
                'ctr_sharded_v1m_hold': ('embedding_gather',),
                'lm_dh256_amp': AMP_TRAIN_KERNELS,
                'lm_dh256_amp_fused': AMP_TRAIN_KERNELS,
                'lm_dh256_amp_hold': AMP_TRAIN_KERNELS,
                'lm_dh256_f32': FLASH_TRAIN_KERNELS,
                'lm_dh256_f32_hold': FLASH_TRAIN_KERNELS,
                'lm_dh256_engine': ENGINE_KERNELS,
                'flash_wide': TRAIN_KERNELS + WIDE_FLASH_KERNELS,
                'flash_wide_amp': AMP_BERT_UNFUSED_KERNELS +
                WIDE_FLASH_KERNELS,
                'train_lm_example': EXAMPLE_KERNELS,
                'train_lm_example_hold': EXAMPLE_KERNELS,
                'nmt_hold': ('embedding_gather',),
                'nmt_train': ('embedding_gather',),
                'nmt_generate': ('embedding_gather',),
                'decode_programs': DECODE_PROGRAM_KERNELS,
                'decode_programs_paged': PAGED_KERNELS,
                'observability_engine': ENGINE_KERNELS,
                'observability_train': EXAMPLE_KERNELS,
                'training_health': EXAMPLE_KERNELS}


_START = time.perf_counter()


def emit(obj):
    """Print one JSON line; a phase's line also carries ``at_s``, the
    seconds since the script started."""
    if 'phase' in obj or 'row' in obj:
        obj = dict(obj, at_s=time.perf_counter() - _START)
    print(json.dumps(obj), flush=True)


def bound(nbytes, flops, product_flops=0, bf16_flops=0):
    """{bound_ms, bound_by}: the larger of bytes over HBM bandwidth and the
    operations' time, where the flops of matrix products
    (``product_flops``) count at the f32-accurate tensor-core rate (165
    TFLOP/s), those of bf16 products (``bf16_flops``) at the bf16 rate (989)
    and the other ``flops`` at the f32 CUDA-core peak (67). A kernel with
    float32 matrix products also gets ``bound_simt_ms``, every flop at 67
    TFLOP/s, the rule of the tables before the tensor-core kernels."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (product_flops / PEAK_TF32X3_FLOPS + flops / PEAK_F32_FLOPS +
             bf16_flops / PEAK_BF16_FLOPS) * 1e3
    out = dict(bound_ms=t_bytes, bound_by='bytes') if t_bytes >= t_ops \
        else dict(bound_ms=t_ops, bound_by='operations')
    if product_flops:
        out['bound_simt_ms'] = max(
            t_bytes, (product_flops + flops) / PEAK_F32_FLOPS * 1e3)
    return out


def same_bits(torch, fn):
    """True when two calls of ``fn`` return bitwise equal tensors."""
    first, second = fn(), fn()
    first = first if isinstance(first, (tuple, list)) else [first]
    second = second if isinstance(second, (tuple, list)) else [second]
    return all(torch.equal(a, b) for a, b in zip(first, second)
               if a is not None)


def eager_ms(torch, fn, iters=50, warmup=5):
    """Mean milliseconds per call over ``iters`` back-to-back eager calls,
    by CUDA events after ``warmup`` calls. At these shapes this is the
    host's launch rate (Python, checks, allocation), not the kernel."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms(torch, fn, calls=20, replays=10):
    """Device milliseconds per call: ``calls`` calls captured in one CUDA
    graph, the graph replayed ``replays`` times between CUDA events. The
    replay has no host work in it, so this is the kernels' own time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return replay_ms(torch, graph, calls, replays)


def replay_ms(torch, graph, calls, replays):
    """Device milliseconds per call of a CUDA graph of ``calls`` calls:
    one replay to warm up, then ``replays`` replays between CUDA events."""
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def rotating_ms(torch, fn, arg_sets, replays=5):
    """Device milliseconds per call of ``fn(*args)`` over every argument set
    of ``arg_sets`` in turn, captured in one CUDA graph whose outputs all
    stay alive (each call writes its own): with enough sets the working
    set exceeds the L2 cache, so no call finds its operands there, as the
    engine's calls do not (its weights and caches are far larger)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn(*arg_sets[0])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        keep = [fn(*args) for args in arg_sets]
    ms = replay_ms(torch, graph, len(arg_sets), replays)
    del keep, graph
    return ms


def rotation(nbytes):
    """How many argument sets of ``nbytes`` each (the bytes one call must
    move) make a working set of three L2 caches (at most 4096 sets)."""
    return int(min(4096, max(4, -(-3 * L2_BYTES // nbytes))))


def gather_times(torch, F, embedding_ops, w, n, g, nbytes):
    """(ms, plain_ms, library_ms) of the gather of ``n`` ids from the table
    ``w``, each over rotating id sets and outputs (`rotating_ms`); the
    ids drawn from ``g`` over the whole table."""
    sets = [(torch.randint(0, w.shape[0], (n,), generator=g,
                           device=w.device),) for _ in range(rotation(nbytes))]
    return (rotating_ms(torch, lambda ids: embedding_ops.embedding_gather(
                w, ids), sets),
            rotating_ms(torch, lambda ids: embedding_ops._gather_ref(w, ids),
                        sets),
            rotating_ms(torch, lambda ids: F.embedding(ids, w), sets))


def check_bound(name, case):
    """Raise when a kernel's device time reads under the least time the card
    could take for its work: the measurement, not the kernel, is wrong
    (operands left in L2 by the calls before)."""
    if 'bound_ms' in case and case['ms'] < case['bound_ms']:
        raise AssertionError('%s: %.6f ms is under its bound %.6f ms (%s)'
                             % (name, case['ms'], case['bound_ms'],
                                {k: v for k, v in case.items()
                                 if not isinstance(v, (dict, list))}))


def backward_ms(torch, fwd, inputs, grad, calls=10, replays=5):
    """Device milliseconds of one backward of ``fwd``: autograd.grad of its
    output at leaf copies of ``inputs`` with ``grad``, captured as
    torch.cuda.make_graphed_callables captures it (warm-up, the forward
    captured in one CUDA graph and replayed once so that what the backward
    saved holds values, ``calls`` backward calls captured in a second graph
    on the same memory pool, whose replays are timed). Everything runs on
    one side stream, the leaves made there too: autograd runs a leaf's
    gradient on the stream that made it, and a wait on another stream
    would break the capture."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        leaves = [t.detach().clone().requires_grad_() for t in inputs]
        for _ in range(3):
            torch.autograd.grad(fwd(*leaves), leaves, grad)
    side.synchronize()
    fwd_graph, bwd_graph = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
    with torch.cuda.graph(fwd_graph, stream=side):
        out = fwd(*leaves)
    with torch.cuda.graph(bwd_graph, pool=fwd_graph.pool(), stream=side):
        for _ in range(calls):
            torch.autograd.grad(out, leaves, grad, retain_graph=True)
    fwd_graph.replay()
    return replay_ms(torch, bwd_graph, calls, replays)


def step_profile(torch, fn, steps=10, host=False, shares=None,
                 kernel_shares=None):
    """Device time of ``steps`` eager calls of ``fn`` by torch.profiler:
    the wall time, the summed kernel time, the busy share, the kernels
    taking the most device time and the host ops that launched the most of
    it; with ``host`` also the host ops taking the most host time of their
    own (``top_host``); with ``shares`` ({label: op names}) the device ms
    a step launched by the host ops named exactly as one of a label's
    names (``shares``); with ``kernel_shares`` ({label: text}) the device
    ms a step of every kernel whose name holds the label's text
    (``kernel_shares``). ``busy_share`` is None when the
    profiler recorded no device time (then it was not measured)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    # the host-side ops that launched the device time (each kernel counted
    # once, under the op that launched it)
    ops = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU
           and e.self_device_time_total > 0]

    def top(evs, n):
        return [dict(name=e.key[:60], count=e.count,
                     ms_per_step=e.self_device_time_total / 1e3 / steps)
                for e in sorted(evs, key=lambda e: e.self_device_time_total,
                                reverse=True)[:n]]

    out = dict(
        steps=steps, wall_ms_per_step=wall_ms / steps,
        device_ms_per_step=dev_ms / steps,
        busy_share=dev_ms / wall_ms if dev_ms > 0 else None,
        launches_per_step=sum(e.count for e in kernels) / steps,
        top=top(kernels, 10), top_ops=top(ops, 10))
    if shares:
        out['shares'] = {
            label: sum(e.self_device_time_total for e in ops
                       if e.key in names) / 1e3 / steps
            for label, names in shares.items()}
    if kernel_shares:
        out['kernel_shares'] = {
            label: sum(e.self_device_time_total for e in kernels
                       if text in e.key) / 1e3 / steps
            for label, text in kernel_shares.items()}
    if host:
        cpu_ops = sorted((e for e in events if e.device_type ==
                          torch.autograd.DeviceType.CPU),
                         key=lambda e: e.self_cpu_time_total, reverse=True)
        out['top_host'] = [dict(name=e.key[:60], count=e.count,
                                ms_per_step=e.self_cpu_time_total / 1e3 /
                                steps) for e in cpu_ops[:10]]
    return out


def ptxas_report(log):
    """{source: {kernel: [registers, spill store bytes, spill load bytes]}}
    from nvcc's ``-Xptxas -v`` output; a kernel is named by its template
    arguments as the mangled name gives them (flash_bwd_dq<64, 4>)."""
    out = {}
    for source, text in log.items():
        kernels, name = {}, None
        for ln in text.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", ln)
            if m:
                name = demangle(m.group(1))
                kernels[name] = [None, None, None]
                continue
            m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads',
                          ln)
            if m and name:
                kernels[name][1:] = [int(m.group(1)), int(m.group(2))]
            m = re.search(r'Used (\d+) registers', ln)
            if m and name:
                kernels[name][0] = int(m.group(1))
        out[source] = kernels
    return out


def demangle(mangled):
    """name<args> of a kernel from its mangled name: the last of its
    length-prefixed name components (after any namespace) and its template
    arguments (float, __nv_bfloat16, integers and bools, as digits);
    ``mangled`` itself when it does not parse."""
    pos, name = (3 if mangled.startswith('_ZN') else 2), None
    while True:
        m = re.compile(r'\d+').match(mangled, pos)
        if not m:
            break
        pos = m.end() + int(m.group())
        name = mangled[m.end():pos]
    if not name:
        return mangled
    args = re.compile(r'I((?:f|13__nv_bfloat16|L\w\d+E)+)E').match(mangled,
                                                                  pos)
    if args:
        name += '<%s>' % ', '.join(
            'float' if a.group(1) else a.group(2) or a.group(3)
            for a in re.finditer(r'(f)|13(__nv_bfloat16)|L\w(\d+)E',
                                 args.group(1)))
    return name


def max_err(torch, got, want):
    return max(float((g.float() - w.float()).abs().max())
               for g, w in zip(got, want))


def ffn_routes(torch, ffn_ops, randn, w1, b1, w2, b2):
    """The skinny route's row limit, measured: at M 8, 16 and 32 the FFN
    through each route (its limit set for the measurement and put back),
    each held to 1e-4 of the plain version. One line per M."""
    saved = ffn_ops._SKINNY_MAX_ROWS
    d = w1.shape[0]
    for n in (8, 16, 32):
        x = randn(n, d)
        want = ffn_ops._ffn_ref(x, w1, b1, w2, b2)
        res = dict(phase='ffn_routes', n=n, limit=saved)
        try:
            for route, limit in (('skinny', 32), ('tile', 0)):
                ffn_ops._SKINNY_MAX_ROWS = limit
                got = ffn_ops.fused_ffn_core(x, w1, b1, w2, b2,
                                             want_pre1=True)
                res[route + '_err'] = max_err(torch, got, want)
                res[route + '_ms'] = cuda_ms(
                    torch, lambda: ffn_ops.fused_ffn_core(x, w1, b1, w2, b2))
        finally:
            ffn_ops._SKINNY_MAX_ROWS = saved
        emit(res)
        if not max(res['skinny_err'], res['tile_err']) <= 1e-4:
            raise AssertionError('fused_ffn routes at M %d: %s' % (n, res))


def check_kernels(torch, F, kt, rows=None, decode_only=False):
    """Phase 3 (at ``rows``: the buckets and the slots when None). With
    ``decode_only`` the gather, LN and FFN only, without the FFN's route
    lines (phase 4b at its step's rows). Returns {kernel name: summary
    dict} with per-shape cases."""
    from paddle_tpu_torch.ops import (attention_ops, embedding_ops,
                                      ffn_ops, nn_ops)
    dev = torch.device('cuda', 0)
    g = torch.Generator(device='cpu').manual_seed(1234)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    d, d_ff, V, H = 512, 2048, 32000, 8
    dh = d // H
    rows = rows or list(BUCKETS) + [SLOTS]
    out = {}

    # embedding gather: exact (a copy); ids in range, plus a clamp probe
    w = randn(V, d, scale=0.02)
    gd = torch.Generator(device=dev).manual_seed(99)
    cases = [gather_case(torch, F, w, n, gd, 'decode') for n in rows]
    probe = torch.tensor([-3, 0, V - 1, V + 5], device=dev)
    clamp_err = max_err(torch, [embedding_ops.embedding_gather(w, probe)],
                        [w[torch.tensor([0, 0, V - 1, V - 1], device=dev)]])
    out['embedding_gather'] = dict(tolerance=0.0, cases=cases,
                                   clamp_err=clamp_err)

    # fused LN + residual: f32, summation order differs from the plain
    # reductions -> 1e-4 absolute on O(1) outputs
    sc = 1.0 + randn(d, scale=0.1)
    bi = randn(d, scale=0.1)
    cases = []
    for n in rows:
        x, r = randn(n, d), randn(n, d)
        got = nn_ops.fused_ln_residual(x, r, sc, bi, 1e-5)
        want = nn_ops._ln_res_ref(x, r, sc, bi, 1e-5)
        err = max_err(torch, got, want)
        nbytes = 4 * n * d * 4 + 2 * d * 4 + 2 * n * 4
        cases.append(dict(**bound(nbytes, 9 * n * d),
            n=n, max_abs_err=err,
            ms=cuda_ms(torch, lambda: nn_ops.fused_ln_residual(
                x, r, sc, bi, 1e-5)),
            eager_ms=eager_ms(torch, lambda: nn_ops.fused_ln_residual(
                x, r, sc, bi, 1e-5)),
            plain_ms=cuda_ms(torch, lambda: nn_ops._ln_res_ref(
                x, r, sc, bi, 1e-5)),
            library_ms=cuda_ms(torch, lambda: F.layer_norm(
                x + r, (d,), sc, bi, 1e-5))))
    out['fused_ln_residual'] = dict(tolerance=1e-4, cases=cases)

    # flash attention, causal, B 1, H 8, dh 64: online softmax vs the
    # plain two-pass softmax -> 1e-4 absolute on O and LSE
    cases = []
    for T in () if decode_only else BUCKETS:
        q, k, v = randn(1, H, T, dh), randn(1, H, T, dh), randn(1, H, T, dh)
        got = attention_ops.flash_attention(q, k, v, causal=True,
                                            return_lse=True)
        o_ref, l_ref = attention_ops._attention_ref(
            q.reshape(H, T, dh), k.reshape(H, T, dh), v.reshape(H, T, dh),
            dh ** -0.5, True)
        err = max_err(torch, [got[0].reshape(H, T, dh), got[1].reshape(H, T)],
                      [o_ref, l_ref])
        nbytes = 4 * H * T * dh * 4 + H * T * 4
        flops = 4 * H * dh * (T * (T + 1) // 2)   # causal half: QK^T + PV
        q3, k3, v3 = (t.reshape(H, T, dh) for t in (q, k, v))
        cases.append(dict(
            T=T, max_abs_err=err, **bound(nbytes, 0, flops),
            deterministic=same_bits(
                torch, lambda: attention_ops.flash_attention(
                    q, k, v, causal=True, return_lse=True)),
            ms=cuda_ms(torch, lambda: attention_ops.flash_attention(
                q, k, v, causal=True)),
            eager_ms=eager_ms(torch, lambda: attention_ops.flash_attention(
                q, k, v, causal=True)),
            plain_ms=cuda_ms(torch, lambda: attention_ops._attention_ref(
                q3, k3, v3, dh ** -0.5, True)),
            library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True))))
    if cases:
        out['flash_attention'] = dict(tolerance=1e-4, cases=cases)

    # FFN tail: two f32 products (K = 512 and 2048) in another summation
    # order than cuBLAS (3xTF32 on the tensor cores, or the skinny route's
    # FMAs), plus erfc -> 1e-4 absolute on y and pre1
    w1, b1 = randn(d, d_ff, scale=0.02), randn(d_ff, scale=0.02)
    w2, b2 = randn(d_ff, d, scale=0.02), randn(d, scale=0.02)
    cases = []
    for n in rows:
        x = randn(n, d)
        got = ffn_ops.fused_ffn_core(x, w1, b1, w2, b2, want_pre1=True)
        want = ffn_ops._ffn_ref(x, w1, b1, w2, b2)
        err = max_err(torch, got, want)
        nbytes = (n * d + d * d_ff + d_ff + d_ff * d + d + n * d) * 4
        case = dict(
            n=n, route=ffn_ops._plan(n, d, d_ff, d)[0], max_abs_err=err,
            **bound(nbytes, 8 * n * d_ff, 2 * n * d * d_ff * 2),
            deterministic=same_bits(torch, lambda: ffn_ops.fused_ffn_core(
                x, w1, b1, w2, b2, want_pre1=True)),
            ms=cuda_ms(torch, lambda: ffn_ops.fused_ffn_core(
                x, w1, b1, w2, b2)),
            eager_ms=eager_ms(torch, lambda: ffn_ops.fused_ffn_core(
                x, w1, b1, w2, b2)),
            plain_ms=cuda_ms(torch, lambda: ffn_ops._ffn_ref(
                x, w1, b1, w2, b2)),
            library_ms=cuda_ms(torch, lambda: F.gelu(x @ w1 + b1) @ w2 + b2))
        if n in (SLOTS, PAGED_SLOTS):
            # the decode step's bitwise contract: row 0 does not move when
            # the other rows change
            other = x.clone()
            other[1:] = randn(n - 1, d)
            a = ffn_ops.fused_ffn_core(x, w1, b1, w2, b2, want_pre1=True)
            b = ffn_ops.fused_ffn_core(other, w1, b1, w2, b2, want_pre1=True)
            case['row_independent'] = all(torch.equal(u[0], v[0])
                                          for u, v in zip(a, b))
            if not case['row_independent']:
                raise AssertionError('fused_ffn: row 0 moved with the other '
                                     'rows at M %d' % n)
        cases.append(case)
    out['fused_ffn'] = dict(tolerance=1e-4, cases=cases)
    if not decode_only:
        ffn_routes(torch, ffn_ops, randn, w1, b1, w2, b2)

    for res in out.values():
        for c in res['cases']:
            if c.get('deterministic') is False:
                raise AssertionError('a kernel gave other bits on a second '
                                     'call: %s' % c)
    for name, res in out.items():
        worst = max(c['max_abs_err'] for c in res['cases'])
        res['max_abs_err'] = max(worst, res.get('clamp_err', 0.0))
        for c in res['cases']:
            emit(dict(phase='kernel', name=name, tolerance=res['tolerance'],
                      **c))
            check_bound(name, c)
        if not res['max_abs_err'] <= res['tolerance']:
            raise AssertionError('%s disagrees with its plain version: max '
                                 'abs err %g > %g' % (name, res['max_abs_err'],
                                                      res['tolerance']))
    return out


def sample_feeds(n, sampled):
    """The sampling feeds of ``n`` rows (temperature, top_k, top_p, u):
    greedy, or temperature 0.8, top-k 50, top-p 0.9."""
    return [np.full(n, 0.8 if sampled else 0.0, 'float32'),
            np.full(n, 50 if sampled else 0, 'int64'),
            np.full(n, 0.9 if sampled else 0.0, 'float32'),
            np.full(n, 0.37, 'float32')]


def signature_feeds(eng, key, rs):
    """Feeds (numpy) of the bound signature ``key`` of ``eng`` at the state
    the timings use: every slot live at position 304 + slot (19/32 of
    max_len) on a full block table (blocks may repeat across slots), a
    prefill of a whole bucket into slot 0 (contiguous) or at positions
    192.. (paged: after phase 4b's shared prefix), tokens drawn from
    ``rs``."""
    c = eng.config
    S, V, kind = c.slots, c.model.vocab_size, key[0]
    tok = rs.randint(2, V, size=S).astype('int64')
    pos = (MAX_LEN * 19 // 32 + np.arange(S)).astype('int64')
    mb = c.max_len // c.block_size
    draft = kind == 'drafter' or (kind == 'prefill_paged' and key[3])
    nb = eng._draft_alloc.num_blocks if draft else c.num_blocks
    tables = None if not c.paged else \
        np.arange(S * mb).reshape(S, mb) % (nb - 1) + 1
    if kind == 'step':
        return [tok, pos] + sample_feeds(S, key[1]) + \
            ([tables] if c.paged else [])
    if kind in ('prefill', 'prefill_paged'):
        b = key[1]
        prompt = rs.randint(2, V, size=(1, b)).astype('int64')
        tail = [np.array([b], 'int64')] + sample_feeds(1, key[2])
        if kind == 'prefill':
            return [prompt, np.array([0], 'int64')] + tail
        return [prompt, np.minimum(PAGED_PREFIX + np.arange(b),
                                   c.max_len - 1),
                np.arange(1, mb + 1)] + tail
    ones = np.ones((S, c.spec_k + 1), 'int64')
    if kind == 'drafter':
        return [tok, pos, tables, ones]
    return [pos[:, None] + np.arange(c.spec_k + 1), tables, ones]


def device_feeds(torch, eng, feeds):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(eng.device)
            for a in feeds]


def graphed_and_eager(torch, eng, key, feeds):
    """Two callables running the signature ``key`` of ``eng`` at ``feeds``,
    each reading its first output to the host (one sync): through its
    CUDA graph (the engine's own path: staging, one host-to-device copy,
    replay), and through its eager function (the model's own methods) on
    device copies of the feeds made once."""
    bs = eng.graphs[key]
    dev = device_feeds(torch, eng, feeds)
    return (lambda: bs(*feeds)[0].cpu()), (lambda: bs.fn(*dev)[0].cpu())


def compare_graphed(torch, eng, key, feeds):
    """The signature's replay against its eager function at one cache state
    and one set of feeds (both write the same cache rows). Returns
    {signature, bitwise, max_abs_diff, ties}; raises unless the outputs are
    bitwise equal, or the logits (the last output) lie within 1e-6 of the
    largest logit and every token that differs is a tie (the eager logits
    of the two within TIE). The drafter has no logits: its drafts must be
    equal."""
    bs = eng.graphs[key]
    got = [t.clone() for t in bs(*feeds)]
    want = bs.fn(*device_feeds(torch, eng, feeds))
    out = dict(signature=str(key), max_abs_diff=0.0, ties=0,
               bitwise=all(torch.equal(a, b) for a, b in zip(got, want)))
    if out['bitwise']:
        return out
    if len(got) < 2:
        raise AssertionError('%s: the replay\'s drafts differ from the eager '
                             'drafter\'s' % (key,))
    lg, lw = got[-1], want[-1]
    out['max_abs_diff'] = float((lg - lw).abs().max())
    if not out['max_abs_diff'] <= 1e-6 * float(lw.abs().max()):
        raise AssertionError('%s: replay and eager logits differ by %g'
                             % (key, out['max_abs_diff']))
    tg, tw = got[0], want[0]
    if key == ('verify',):          # the drafts, then each row's verdict
        n = tg.numel() - lw.shape[0]
        if not torch.equal(tg[:n], tw[:n]):
            raise AssertionError('verify: the drafts it returns differ')
        tg, tw = tg[n:], tw[n:]
    rows = (tg != tw).nonzero().reshape(-1).tolist()
    for r in rows:
        gap = abs(float(lw[r, tg[r]] - lw[r, tw[r]]))
        if not gap <= TIE:
            raise AssertionError('%s: row %d\'s token %d against the eager '
                                 '%d with a logit gap of %g'
                                 % (key, r, int(tg[r]), int(tw[r]), gap))
    out['ties'] = len(rows)
    return out


def check_graphs(torch, eng, rs):
    """`compare_graphed` for every signature of ``eng`` (the verify step
    right after the drafter, whose drafts it reads); a summary."""
    res = []
    for key in sorted(eng.graphs, key=str):
        if key != ('verify',):
            res.append(compare_graphed(torch, eng, key,
                                       signature_feeds(eng, key, rs)))
        if key == ('drafter',):
            res.append(compare_graphed(torch, eng, ('verify',),
                                       signature_feeds(eng, ('verify',), rs)))
    return dict(signatures=len(res),
                bitwise=sum(1 for r in res if r['bitwise']),
                max_abs_diff=max(r['max_abs_diff'] for r in res),
                ties=sum(r['ties'] for r in res),
                not_bitwise=[r for r in res if not r['bitwise']])


def check_warm(name, warm, signatures):
    """warmup() bound and captured every signature: ``signatures`` each."""
    if not warm['signatures'] == warm['graphs'] == signatures:
        raise AssertionError('%s: warmup bound %d signatures and captured %d '
                             'graphs, expected %d' % (
                                 name, warm['signatures'], warm['graphs'],
                                 signatures))


def check_no_late_capture(name, stats):
    g = stats['graphs']
    if g['captures_after_warmup'] != 0 or g['replays'] <= 0:
        raise AssertionError('%s: graphs after the traffic %s' % (name, g))


def host_ms(torch, fn, calls):
    """Host milliseconds per call of ``fn`` (each call ends in its own read
    to the host), after one call."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / calls * 1e3


def graph_device_ms(torch, eng, key):
    """Device milliseconds of one replay of the signature's CUDA graph,
    between CUDA events (no host work inside)."""
    return replay_ms(torch, eng.graphs[key]._graph, 1, 20)


def replay_launches(eng):
    """{signature: the kernel launches one replay runs (wrapper counts)}."""
    return {str(k): sum(bs.launches.values())
            for k, bs in sorted(eng.graphs.items(), key=str)}


class Traced(object):
    """A bound step whose every call also hands (feeds, outputs) to
    ``record``; other attributes are the step's."""

    def __init__(self, bs, record):
        self.bs, self.record = bs, record

    def __call__(self, *feeds):
        out = self.bs(*feeds)
        self.record(feeds, out)
        return out

    def __getattr__(self, name):
        return getattr(self.bs, name)


def engine_work(rs, vocab_size):
    """Phase 4's requests: N_REQUESTS prompts of 5..256 tokens from ``rs``,
    every other one sampled with a pinned seed, as (prompt, kwargs)."""
    work = []
    for i, n in enumerate(np.linspace(5, BUCKETS[-1],
                                      N_REQUESTS).astype(int)):
        prompt = rs.randint(2, vocab_size, size=int(n))
        work.append((prompt, dict(temperature=0.8, top_k=50, top_p=0.9,
                                  sample_seed=1000 + i) if i % 2 else {}))
    return work


def run_engine(torch, kt, smi):
    """Phase 4: the full-width engine. Returns (summary, launch counts)."""
    from paddle_tpu_torch.models.transformer import LMConfig, TransformerLM
    from paddle_tpu_torch.serving import GenerateConfig, GenerateEngine
    cfg = GenerateConfig(
        model=LMConfig(dropout=0.0, attn_dropout=0.0,
                       use_flash_attention=True),
        slots=SLOTS, max_len=MAX_LEN, prompt_buckets=list(BUCKETS),
        max_new_tokens=NEW_TOKENS, seed=0)
    rs = np.random.RandomState(7)
    work = engine_work(rs, cfg.model.vocab_size)

    torch.cuda.reset_peak_memory_stats()
    eng = GenerateEngine(cfg)                       # cuda:0
    warm = eng.warmup()
    check_warm('engine', warm, 2 + 2 * len(BUCKETS))
    kt.reset_counts()
    t0 = time.perf_counter()
    with eng:
        reqs = [eng.submit(p, max_new_tokens=NEW_TOKENS, **kw)
                for p, kw in work]
        outs = [r.result(600) for r in reqs]
    wall = time.perf_counter() - t0
    refs = [eng.generate_once(p, max_new_tokens=NEW_TOKENS, **kw)
            for p, kw in work]
    counts = kt.launch_counts()
    stats = eng.stats()
    check_no_late_capture('engine', stats)

    reasons = [o.finish_reason for o in outs]
    if reasons != ['length'] * N_REQUESTS:
        raise AssertionError('unexpected finish reasons %s' % reasons)
    if any(len(o) != NEW_TOKENS for o in outs):
        raise AssertionError('a request did not get %d tokens' % NEW_TOKENS)
    mismatch = [i for i, (o, r) in enumerate(zip(outs, refs)) if list(o) != r]
    if mismatch:
        raise AssertionError('concurrent != sequential for requests %s'
                             % mismatch)
    idle = [k for k in ENGINE_KERNELS if counts[k] <= 0]
    if idle:
        raise AssertionError('kernels never launched on the main path: %s'
                             % idle)

    # every signature's replay against its eager function, then the
    # timings of the step and each bucket's prefill: host clock to the
    # read of the result, graphed and eager at the same feeds, and the
    # replay's device time
    graph_check = check_graphs(torch, eng, rs)
    dev, model = eng.device, eng.model
    prefill_ms = {}
    for b in BUCKETS:
        key = ('prefill', b, False)
        graphed, eager = graphed_and_eager(torch, eng, key,
                                           signature_feeds(eng, key, rs))
        prefill_ms[str(b)] = dict(
            graphed=host_ms(torch, graphed, 5), eager=host_ms(torch, eager, 5),
            eager_again=host_ms(torch, eager, 5),
            graphed_again=host_ms(torch, graphed, 5),
            device=graph_device_ms(torch, eng, key))
    pf_profile = {str(BUCKETS[-1]): dict(
        graphed=step_profile(torch, graphed, steps=5),
        eager=step_profile(torch, eager, steps=5))}
    key = ('step', False)
    graphed, eager = graphed_and_eager(torch, eng, key,
                                       signature_feeds(eng, key, rs))
    step_ms = {name: host_ms(torch, fn, 20) for name, fn in (
        ('graphed', graphed), ('eager', eager), ('eager_again', eager),
        ('graphed_again', graphed))}
    step_ms['device'] = graph_device_ms(torch, eng, key)
    # the least time a step can take: it must read every weight (of the
    # embedding table only its SLOTS rows) and the whole K/V cache
    # (kv_decode_attention reads all max_len rows of every slot)
    step_bytes = sum(p.numel() * 4 for n, p in model.p.items()
                     if n != 'tok_emb.w') + SLOTS * cfg.model.d_model * 4 + \
        (model.k_cache.numel() + model.v_cache.numel()) * 4
    profile = dict(graphed=step_profile(torch, graphed),
                   eager=step_profile(torch, eager))

    # the card's logits against the plain-PyTorch path on the CPU, same
    # weights and inputs: one 64-token prefill, then one decode step
    cpu = TransformerLM(cfg.model, {k: v.cpu() for k, v in model.p.items()},
                        MAX_LEN)
    cpu.allocate_cache(SLOTS)
    prompt = rs.randint(2, cfg.model.vocab_size, size=(1, BUCKETS[0]))
    _, lg_gpu = model.prefill(torch.from_numpy(prompt).to(dev), 1, 40)
    _, lg_cpu = cpu.prefill(torch.from_numpy(prompt), 1, 40)
    tok = np.zeros(SLOTS, 'int64')
    tok[1] = 17
    posv = np.zeros(SLOTS, 'int64')
    posv[1] = 40
    _, sg_gpu = model.decode_step(torch.from_numpy(tok).to(dev),
                                  torch.from_numpy(posv).to(dev))
    _, sg_cpu = cpu.decode_step(torch.from_numpy(tok), torch.from_numpy(posv))
    lg_gpu, sg_gpu = lg_gpu.cpu(), sg_gpu[1].cpu()
    if not (torch.isfinite(lg_gpu).all() and torch.isfinite(sg_gpu).all()):
        raise AssertionError('non-finite logits on the card')
    if tuple(lg_gpu.shape) != (1, cfg.model.vocab_size):
        raise AssertionError('prefill logits of shape %s'
                             % (tuple(lg_gpu.shape),))
    logit_err = max(float((lg_gpu - lg_cpu).abs().max()),
                    float((sg_gpu - sg_cpu[1]).abs().max()))
    # six layers of f32 in two summation orders: 1e-3 absolute on logits
    # of magnitude ~1
    if not logit_err <= 1e-3:
        raise AssertionError('card vs CPU logits differ by %g' % logit_err)

    gen = sum(len(o) for o in outs)
    summary = dict(
        phase='engine', card=smi, requests=N_REQUESTS, new_tokens=gen,
        warmup=warm, wall_s=wall, tokens_per_s=gen / wall,
        finish_reasons=sorted(set(reasons)), concurrent_equals_sequential=True,
        graphs_vs_eager=graph_check, launches_per_replay=replay_launches(eng),
        prefill_ms=prefill_ms, decode_step_ms=step_ms,
        decode_step_floor_ms=step_bytes / PEAK_BYTES_PER_S * 1e3,
        decode_step_bytes=step_bytes, decode_step_profile=profile,
        prefill_profile=pf_profile,
        logits_max_abs_err_vs_cpu=logit_err, launches=counts,
        stats=stats, peak_mem_bytes=torch.cuda.max_memory_allocated())
    return summary, counts


def traced_once(eng, prompt, kw):
    """(tokens, logits): ``eng.generate_once(prompt, max_new_tokens=
    NEW_TOKENS, **kw)`` and, on the CPU, the logits each of its tokens was
    chosen from (the final prefill's, then slot 0's of each step), read
    from the outputs of its bound prefill and step signatures (their CUDA
    graphs' replays) as it runs."""
    if not eng._warm:
        eng.warmup()
    rec, bound = [], eng.graphs

    def record(feeds, out):
        rec.append(out[1][0].cpu())

    eng._graphs.update({k: Traced(bs, record) for k, bs in bound.items()
                        if k[0] in ('step', 'prefill', 'prefill_paged')})
    try:
        tokens = eng.generate_once(prompt, max_new_tokens=NEW_TOKENS, **kw)
    finally:
        eng._graphs.update(bound)
    # a chunked prefill's earlier chunks come first: the last len(tokens)
    return tokens, rec[-len(tokens):]


def first_tie(got, ref, logits):
    """None when ``got`` equals the reference tokens ``ref``; when they
    first differ at a tie (the reference run's logits of the two tokens
    within TIE), that step, the tokens and their gap; else raises."""
    for t, (a, b) in enumerate(zip(got, ref)):
        if a != b:
            gap = abs(float(logits[t][a] - logits[t][b]))
            if not gap <= TIE:
                raise AssertionError(
                    'tokens differ at step %d (%d against the reference\'s '
                    '%d) with a logit gap of %g' % (t, a, b, gap))
            return dict(step=t, token=int(a), ref_token=int(b), gap=gap)
    if len(got) != len(ref):
        raise AssertionError('%d tokens against the reference\'s %d'
                             % (len(got), len(ref)))
    return None


def paged_config(**kw):
    """Phase 4b's engine configuration (the flagship LM, dropout 0), with
    ``kw`` on top."""
    from paddle_tpu_torch.models.transformer import LMConfig
    from paddle_tpu_torch.serving import GenerateConfig
    model_cfg = LMConfig(dropout=0.0, attn_dropout=0.0,
                         use_flash_attention=True)
    return GenerateConfig(
        model=model_cfg, slots=PAGED_SLOTS, max_len=MAX_LEN,
        prompt_buckets=list(BUCKETS), max_new_tokens=NEW_TOKENS, seed=0,
        paged=True, block_size=PAGED_BLOCK, num_blocks=PAGED_BLOCKS, **kw)


def paged_prompts(rs, V):
    """Phase 4b's 24 prompts in submission order, and each one's kind
    ('shared', 'cow', 'long' or 'short'), drawn from ``rs``."""
    prefix = rs.randint(2, V, size=PAGED_PREFIX)
    shared = [np.concatenate([prefix, rs.randint(2, V, size=int(n))])
              for n in np.linspace(*PAGED_SUFFIX, num=12)]
    cow = [prefix] * 4
    long_ = [rs.randint(2, V, size=int(n))
             for n in np.linspace(*PAGED_LONG, num=4)]
    short = [rs.randint(2, V, size=int(n))
             for n in np.linspace(*PAGED_SHORT, num=4)]
    # the copy-on-write prompts right after the first shared one, whose
    # admission registers the prefix's blocks: each of them is a hit
    order = [(shared[0], 'shared')] + [(p, 'cow') for p in cow]
    for i in range(4):
        order += [(p, 'shared') for p in shared[1 + 3 * i:4 + 3 * i]]
        order += [(long_[i], 'long'), (short[i], 'short')]
    prompts, kinds = zip(*order)
    return prompts, list(kinds)


def run_engine_paged(torch, kt, smi):
    """Phase 4b: the full-width paged engine. Returns (summary, launch
    counts of its traffic)."""
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.models.transformer import TransformerLM
    from paddle_tpu_torch.serving import GenerateConfig, GenerateEngine
    cfg = paged_config()
    model_cfg = cfg.model
    V = model_cfg.vocab_size
    rs = np.random.RandomState(17)
    prompts, kinds = paged_prompts(rs, V)
    work = [(p, dict(temperature=0.8, top_k=50, top_p=0.9,
                     sample_seed=2000 + i) if i % 2 else {})
            for i, p in enumerate(prompts)]

    torch.cuda.reset_peak_memory_stats()
    eng = GenerateEngine(cfg)                       # cuda:0
    warm = eng.warmup()
    check_warm('engine_paged', warm, 2 + 2 * len(BUCKETS))
    kt.reset_counts()
    before = monitor.counters()
    t0 = time.perf_counter()
    with eng:
        reqs = [eng.submit(p, max_new_tokens=NEW_TOKENS, **kw)
                for p, kw in work]
        outs = [r.result(600) for r in reqs]
    wall = time.perf_counter() - t0
    counts = kt.launch_counts()
    stats = eng.stats()
    counters = monitor.counter_delta(before)
    check_no_late_capture('engine_paged', stats)

    reasons = [o.finish_reason for o in outs]
    if reasons != ['length'] * len(work):
        raise AssertionError('unexpected finish reasons %s' % reasons)
    if stats['blocks']['in_use'] != 0:
        raise AssertionError('blocks in use after stop(): %s'
                             % stats['blocks'])
    idle = [k for k in PAGED_KERNELS if counts[k] <= 0]
    if idle:
        raise AssertionError('kernels never launched on the paged path: %s'
                             % idle)
    if not stats['peak_active'] > SLOTS:
        raise AssertionError('peak_active %d is not above the contiguous '
                             'engine\'s %d slots' % (stats['peak_active'],
                                                     SLOTS))
    hits = counters.get('kv_prefix_hit_total{outcome=hit}', 0)
    cows = counters.get('kv_block_cow_total', 0)
    # a shared prompt's hit caches its 12 prefix blocks; a copy-on-write
    # prompt (the prefix alone) recomputes its last position
    saved = PAGED_PREFIX * (hits - cows) + (PAGED_PREFIX - 1) * cows
    if hits < 15 or cows < 4 or \
            counters.get('kv_prefix_tokens_saved_total') != saved:
        raise AssertionError('prefix sharing: %s (tokens saved should be '
                             '%d)' % (counters, saved))

    # (a) each request against its own paged generate_once; (b) each
    # greedy one against contiguous engines on the same weights
    ties = []
    for i, ((p, kw), out) in enumerate(zip(work, outs)):
        ref, logits = traced_once(eng, p, kw)
        tie = first_tie(list(out), ref, logits)
        if tie:
            ties.append(dict(request=i, kind=kinds[i], reference='paged',
                             **tie))
    if eng._alloc.in_use() != 0:
        raise AssertionError('generate_once left blocks in use')
    params = dict(eng.model.p)
    greedy = [(i, p) for i, (p, kw) in enumerate(work) if not kw]
    for ladder in (list(BUCKETS), list(BUCKETS) + [MAX_LEN]):
        contig = GenerateEngine(GenerateConfig(
            model=model_cfg, slots=SLOTS, max_len=MAX_LEN,
            prompt_buckets=ladder, max_new_tokens=NEW_TOKENS),
            params=params)
        for i, p in greedy:
            if (p.size > BUCKETS[-1]) != (len(ladder) > len(BUCKETS)):
                continue
            ref, logits = traced_once(contig, p, {})
            tie = first_tie(list(outs[i]), ref, logits)
            if tie:
                ties.append(dict(request=i, kind=kinds[i],
                                 reference='contiguous %s' % ladder, **tie))
        del contig
    for tie in ties:
        emit(dict(phase='engine_paged_tie', **tie))

    # every signature's replay against its eager function; timings (host
    # clock to the read of the result, graphed and eager at the same
    # feeds; the replay's device time): a suffix prefill after the
    # 192-token prefix in each bucket, the paged step at 16 slots beside
    # an eager contiguous one at 16 slots, all by torch.profiler too
    graph_check = check_graphs(torch, eng, rs)
    dev, model = eng.device, eng.model
    mb = MAX_LEN // PAGED_BLOCK
    table = torch.arange(1, mb + 1, device=dev)
    prefill_ms = {}
    for b in BUCKETS:
        key = ('prefill_paged', b, False, False)
        graphed, eager = graphed_and_eager(torch, eng, key,
                                           signature_feeds(eng, key, rs))
        prefill_ms[str(b)] = dict(
            graphed=host_ms(torch, graphed, 5), eager=host_ms(torch, eager, 5),
            eager_again=host_ms(torch, eager, 5),
            graphed_again=host_ms(torch, graphed, 5),
            device=graph_device_ms(torch, eng, key))
    pf_profile = dict(graphed=step_profile(torch, graphed, steps=5),
                      eager=step_profile(torch, eager, steps=5, host=True))
    key = ('step', False)
    feeds = signature_feeds(eng, key, rs)
    paged_graphed, paged_step = graphed_and_eager(torch, eng, key, feeds)
    tok, pos = device_feeds(torch, eng, feeds[:2])
    contig = TransformerLM(model_cfg, params, MAX_LEN)
    contig.allocate_cache(PAGED_SLOTS)
    contig_step = lambda: contig.decode_step(tok, pos)[0].cpu()  # noqa: E731
    step_ms = {}
    for name, fn in (('paged_graphed', paged_graphed), ('paged', paged_step),
                     ('contiguous', contig_step),
                     ('contiguous_again', contig_step),
                     ('paged_again', paged_step),
                     ('paged_graphed_again', paged_graphed)):
        step_ms[name] = host_ms(torch, fn, 20)
    step_ms['paged_graphed_device'] = graph_device_ms(torch, eng, key)
    profiles = {'paged_graphed': step_profile(torch, paged_graphed),
                'paged': step_profile(torch, paged_step, host=True),
                'contiguous': step_profile(torch, contig_step, host=True)}
    d, Ln = model_cfg.d_model, model_cfg.n_layer
    weights = sum(p.numel() * 4 for n, p in params.items()
                  if n != 'tok_emb.w') + PAGED_SLOTS * d * 4
    # the paged step's gather reads S x max_blocks x block_size rows of K
    # and of V a layer and writes them again; the contiguous step reads its
    # whole cache once
    floors = {'paged': weights + 2 * 2 * Ln * PAGED_SLOTS * MAX_LEN * d * 4,
              'contiguous': weights + 2 * Ln * PAGED_SLOTS * MAX_LEN * d * 4}
    del contig

    # (g) the card's logits against the plain-PyTorch path on the CPU: a
    # 100-token paged prefill (bucket 128), a prefix hit's 40-token suffix
    # prefill (bucket 64) over its first 96 rows, and one paged step
    cpu = TransformerLM(model_cfg, {k: v.cpu() for k, v in params.items()},
                        MAX_LEN)
    cpu.allocate_paged_cache(PAGED_BLOCKS, PAGED_BLOCK)
    b1, b0 = BUCKETS[1], BUCKETS[0]
    hit, n_hit = b1 * 3 // 4, b0 * 5 // 8
    prompt = rs.randint(2, V, size=(1, hit + n_hit))
    errs = {}
    for name, start, b, n in (('prefill', 0, b1, b1 * 25 // 32),
                              ('prefix_hit', hit, b0, n_hit)):
        chunk = np.zeros((1, b), 'int64')
        chunk[0, :n] = prompt[0, start:start + n]
        pos = np.arange(start, start + b)
        got = model.prefill_paged(torch.from_numpy(chunk).to(dev),
                                  torch.from_numpy(pos).to(dev), table, n)
        want = cpu.prefill_paged(torch.from_numpy(chunk),
                                 torch.from_numpy(pos), table.cpu(), n)
        errs[name] = float((got[1].cpu() - want[1]).abs().max())
        first = int(want[0][0])
    tok = np.zeros(PAGED_SLOTS, 'int64')
    tok[1] = first
    posv = np.zeros(PAGED_SLOTS, 'int64')
    posv[1] = hit + n_hit
    tab = np.zeros((PAGED_SLOTS, mb), 'int64')
    tab[1] = np.arange(1, mb + 1)
    _, sg_gpu = model.decode_step(*(torch.from_numpy(a).to(dev)
                                    for a in (tok, posv)),
                                  tables=torch.from_numpy(tab).to(dev))
    _, sg_cpu = cpu.decode_step(torch.from_numpy(tok),
                                torch.from_numpy(posv),
                                tables=torch.from_numpy(tab))
    sg_gpu = sg_gpu[1].cpu()
    if not torch.isfinite(sg_gpu).all():
        raise AssertionError('non-finite paged step logits on the card')
    errs['step'] = float((sg_gpu - sg_cpu[1]).abs().max())
    # phase 4's limit: six layers of f32 in two summation orders
    if not max(errs.values()) <= 1e-3:
        raise AssertionError('card vs CPU paged logits differ: %s' % errs)

    gen = sum(len(o) for o in outs)
    summary = dict(
        phase='engine_paged', card=smi, requests=len(work), new_tokens=gen,
        slots=PAGED_SLOTS, num_blocks=PAGED_BLOCKS, block_size=PAGED_BLOCK,
        kinds={k: kinds.count(k) for k in sorted(set(kinds))},
        warmup=warm, wall_s=wall, tokens_per_s=gen / wall,
        finish_reasons=sorted(set(reasons)), ties=len(ties),
        counters=counters, graphs_vs_eager=graph_check,
        launches_per_replay=replay_launches(eng),
        prefill_ms_after_prefix=prefill_ms,
        prefill_profile={str(BUCKETS[-1]): pf_profile}, decode_step_ms=step_ms,
        decode_step_floor_ms={k: v / PEAK_BYTES_PER_S * 1e3
                              for k, v in floors.items()},
        decode_step_bytes=floors, decode_step_profile=profiles,
        logits_max_abs_err_vs_cpu=errs, launches=counts, stats=stats,
        peak_mem_bytes=torch.cuda.max_memory_allocated())
    return summary, counts


def lost_proposals(rounds):
    """Where the verify step turned down a draft, from the (drafts, verdict,
    gap: device tensors; counted: numpy) that `trace_verify` kept for each
    round: per slot and round its first refused draft that the round
    counted, with
    the target's logit gap between its own token and the draft's, and the
    number of counted drafts lost there."""
    out = []
    for r, rec in enumerate(rounds):
        d, v, gap = (t.cpu().numpy() for t in rec[:3])
        counted = rec[3]
        for s in range(d.shape[0]):
            miss = np.flatnonzero((d[s] != v[s]) & (counted[s] != 0))
            if miss.size:
                t = int(miss[0])
                out.append(dict(round=r, slot=s, draft=t,
                                gap=float(gap[s, t]),
                                lost=int(counted[s, t:].sum())))
    return out


def trace_verify(eng, rounds):
    """Wrap the engine's bound verify step (`Traced`; put ``eng.graphs[(
    'verify',)]`` back to undo) so that each call appends to ``rounds``, on
    the device, its drafts, its argmax at the rows that judge them, the
    logit gap between the two and which drafts the round counts."""
    S, K = eng.config.slots, eng.config.spec_k
    W = K + 1

    def record(feeds, out):
        both, logits = out
        drafts = both[:S * K].view(S, K).clone()
        lg = logits.view(S, W, -1)[:, :-1]
        gap = lg.max(-1).values - lg.gather(-1, drafts[..., None])[..., 0]
        rounds.append((drafts, both[S * K:].view(S, W)[:, :-1].clone(), gap,
                       feeds[2][:, 1:].copy()))

    eng._graphs[('verify',)] = Traced(eng.graphs[('verify',)], record)


def run_engine_spec(torch, kt, smi):
    """Phase 4c: speculative decoding on phase 4b's engine. Returns (summary,
    launch counts of the speculative traffic)."""
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.models.transformer import LMConfig, TransformerLM
    from paddle_tpu_torch.serving import GenerateEngine
    cfg = paged_config()
    V = cfg.model.vocab_size
    prompts, kinds = paged_prompts(np.random.RandomState(17), V)
    greedy = [(p, {}) for p in prompts]
    mixed = [(p, dict(temperature=0.8, top_k=50, top_p=0.9,
                      sample_seed=3000 + i)
              if i % SPEC_SAMPLED_EVERY == 1 else {})
             for i, p in enumerate(prompts)]
    sampled_tokens = dict(max_new_tokens=SPEC_SAMPLED_TOKENS)

    torch.cuda.reset_peak_memory_stats()
    plain = GenerateEngine(cfg)                     # cuda:0, seed 0
    params = dict(plain.model.p)
    skip = {n: t for n, t in params.items() if n.startswith('layer_0.') or
            n in ('tok_emb.w', 'final_ln.w', 'final_ln.b', 'lm_head.w')}
    spec_cfg = paged_config(speculative=True, spec_k=SPEC_K)
    skip_cfg = paged_config(speculative=True, spec_k=SPEC_K,
                            draft_model=LMConfig(n_layer=1, dropout=0.0,
                                                 attn_dropout=0.0))
    engines = {'target': GenerateEngine(spec_cfg, params=params),
               'layer_skip': GenerateEngine(skip_cfg, params=params,
                                            draft_params=skip),
               'fallback': GenerateEngine(spec_cfg, params=params)}
    for name, eng in engines.items():
        # both drafts share the target's weights: no copy
        names = skip if name == 'layer_skip' else params
        if any(eng.draft.p[n].data_ptr() != params[n].data_ptr()
               for n in names):
            raise AssertionError('the %s draft copied the target\'s '
                                 'weights' % name)
    warm = {}
    nb = len(BUCKETS)
    for name, eng, n in (('target', engines['target'], 4 + 2 * nb),
                         ('layer_skip', engines['layer_skip'], 4 + 3 * nb),
                         ('fallback', engines['fallback'], 4 + 2 * nb),
                         ('plain', plain, 2 + 2 * nb)):
        warm[name] = eng.warmup()
        check_warm('engine_spec %s' % name, warm[name], n)

    def drive(eng, work):
        before = monitor.counters()
        t0 = time.perf_counter()
        with eng:
            reqs = [eng.submit(p, **dict(kw, **(
                sampled_tokens if kw else dict(max_new_tokens=NEW_TOKENS))))
                for p, kw in work]
            outs = [r.result(600) for r in reqs]
            held = dict(eng.stats()['blocks'])
        return dict(outs=outs, wall=time.perf_counter() - t0, held=held,
                    stats=eng.stats(),
                    counters=monitor.counter_delta(before))

    verified = []
    verify_bound = engines['target'].graphs[('verify',)]
    trace_verify(engines['target'], verified)
    kt.reset_counts()
    runs = {'target': drive(engines['target'], greedy),
            'layer_skip': drive(engines['layer_skip'], greedy),
            'fallback': drive(engines['fallback'], mixed)}
    counts = kt.launch_counts()
    engines['target']._graphs[('verify',)] = verify_bound
    runs['plain'] = drive(plain, greedy)
    for name, run in runs.items():
        check_no_late_capture('engine_spec %s' % name, run['stats'])

    for name, run in runs.items():
        st = run['stats']
        if any(o.finish_reason != 'length' for o in run['outs']):
            raise AssertionError('%s: unexpected finish reasons' % name)
        if run['held']['in_use'] != run['held']['prefix_entries'] or \
                st['blocks']['in_use'] != 0 or \
                st.get('spec', {}).get('draft_blocks_in_use', 0) != 0:
            raise AssertionError('%s: pools not conserved: %s, after '
                                 'stop() %s' % (name, run['held'], st))
    idle = [k for k in PAGED_KERNELS if counts[k] <= 0]
    if idle:
        raise AssertionError('kernels never launched on the speculative '
                             'path: %s' % idle)
    lost = lost_proposals(verified)
    for miss in lost:
        emit(dict(phase='engine_spec_lost', draft='target', **miss))
    acc = runs['target']['stats']['spec']
    if not acc['accept_rate'] >= 0.95:
        raise AssertionError('the target-weights draft accepted %s of its '
                             'proposals' % acc['accept_rate'])
    fb = runs['fallback']['counters']
    if not (fb.get('spec_fallback_total', 0) > 0 and
            fb.get('spec_stale_draft_rounds_total', 0) >= 1):
        raise AssertionError('no fallback and resync: %s' % fb)

    # every greedy token against the plain paged engine's generate_once, a
    # sampled one against its own engine's (the first 8 of its tokens), a
    # token differing at a tie only
    ties, refs = [], {}
    for name in ('target', 'layer_skip', 'fallback'):
        for i, ((p, kw), out) in enumerate(zip(
                mixed if name == 'fallback' else greedy,
                runs[name]['outs'])):
            key = (i, bool(kw))
            if key not in refs:
                refs[key] = traced_once(engines['fallback'] if kw else plain,
                                        p, kw)
            ref, logits = refs[key]
            tie = first_tie(list(out), ref[:len(out)], logits[:len(out)])
            if tie:
                ties.append(dict(run=name, request=i, kind=kinds[i], **tie))
    for tie in ties:
        emit(dict(phase='engine_spec_tie', **tie))

    # one full-width verify step on the card against the CPU, and each of
    # its rows against the card's one-token step at that position: a
    # 100-token prompt in slot 1, then its next token and 4 drafts
    model = engines['target'].model
    dev = model.device
    cpu = TransformerLM(cfg.model, {k: v.cpu() for k, v in params.items()},
                        MAX_LEN)
    cpu.allocate_paged_cache(PAGED_BLOCKS, PAGED_BLOCK)
    mb, W, n = MAX_LEN // PAGED_BLOCK, SPEC_K + 1, BUCKETS[1] * 25 // 32
    rs = np.random.RandomState(23)
    chunk = np.zeros((1, BUCKETS[1]), 'int64')
    chunk[0, :n] = rs.randint(2, V, size=n)
    tab = np.zeros((PAGED_SLOTS, mb), 'int64')
    tab[1] = np.arange(1, mb + 1)
    vt, vp, vv = (np.zeros((PAGED_SLOTS, W), 'int64') for _ in range(3))
    vp[1], vv[1] = n + np.arange(W), 1
    vt[1] = rs.randint(2, V, size=W)    # the verify rows' tokens: any will do
    logits = []                         # the card's, then the CPU's
    for m in (model, cpu):
        t = lambda a: torch.from_numpy(a).to(m.device)  # noqa: E731
        m.prefill_paged(t(chunk), t(np.arange(BUCKETS[1])), t(tab[1]), n)
        logits.append(m.verify_step(t(vt), t(vp), t(tab), t(vv))[1][
            W:2 * W].cpu())
    ver = logits[0]
    if not torch.isfinite(ver).all():
        raise AssertionError('non-finite verify logits on the card')
    errs = {'verify_vs_cpu': float((ver - logits[1]).abs().max())}
    steps = []
    for j in range(W):
        tok, posv = np.zeros(PAGED_SLOTS, 'int64'), np.zeros(PAGED_SLOTS,
                                                             'int64')
        tok[1], posv[1] = vt[1, j], vp[1, j]
        steps.append(model.decode_step(
            *(torch.from_numpy(a).to(dev) for a in (tok, posv)),
            tables=torch.from_numpy(tab).to(dev))[1][1].cpu())
    errs['verify_vs_step'] = float((ver - torch.stack(steps)).abs().max())
    # phase 4's limit: six layers of f32 in two summation orders
    if not max(errs.values()) <= 1e-3:
        raise AssertionError('verify logits differ: %s' % errs)
    del cpu

    # every signature's replay against its eager function (both drafts'
    # engines, the plain one); one round's host ms, graphed (the engine's
    # path: the drafter's and the verify's replays and one read) and eager
    # (the drafter, the verify rows built on the device, the verify step
    # and one read), 16 slots at position 304 on full tables (blocks may
    # repeat across slots), beside the plain step; device times of the
    # graphs' replays and by torch.profiler
    graph_check = {name: check_graphs(torch, engines[name], rs)
                   for name in ('target', 'layer_skip')}
    graph_check['plain'] = check_graphs(torch, plain, rs)
    feeds = {}
    for name in ('target', 'layer_skip'):
        eng = engines[name]
        # the drafter's positions, the verify's window over them
        feeds[name] = [signature_feeds(eng, ('drafter',), rs),
                       signature_feeds(eng, ('verify',), rs)]

    def graphed_round(name):
        d, v = (engines[name].graphs[k] for k in (('drafter',), ('verify',)))
        df, vf = feeds[name]
        return lambda: (d(*df), v(*vf)[0].cpu())

    def eager_round(name):
        eng = engines[name]
        tok, pos, dtab, ones = device_feeds(torch, eng, feeds[name][0])
        vpos, tab, _ = device_feeds(torch, eng, feeds[name][1])
        return lambda: eng.model.verify_step(torch.cat(
            [tok[:, None], eng.draft.draft_steps(tok, pos, dtab, ones,
                                                 SPEC_K)], 1),
            vpos, tab, ones)[0].cpu()

    key = ('step', False)
    plain_graphed, plain_step = graphed_and_eager(
        torch, plain, key, signature_feeds(plain, key, rs))
    round_ms = {}
    for name, fn in (('plain_step_graphed', plain_graphed),
                     ('plain_step', plain_step),
                     ('round_target_graphed', graphed_round('target')),
                     ('round_target', eager_round('target')),
                     ('round_layer_skip_graphed', graphed_round('layer_skip')),
                     ('round_layer_skip', eager_round('layer_skip')),
                     ('round_layer_skip_again', eager_round('layer_skip')),
                     ('round_layer_skip_graphed_again',
                      graphed_round('layer_skip')),
                     ('round_target_again', eager_round('target')),
                     ('round_target_graphed_again', graphed_round('target')),
                     ('plain_step_again', plain_step),
                     ('plain_step_graphed_again', plain_graphed)):
        round_ms[name] = host_ms(torch, fn, 10)
    device_ms = {'plain_step': graph_device_ms(torch, plain, key)}
    for name in ('target', 'layer_skip'):
        for k in ('drafter', 'verify'):
            device_ms['%s_%s' % (k, name)] = graph_device_ms(
                torch, engines[name], (k,))
    profiles = {'round_target_graphed': step_profile(
                    torch, graphed_round('target'), steps=5),
                'round_layer_skip_graphed': step_profile(
                    torch, graphed_round('layer_skip'), steps=5),
                'round_target': step_profile(torch, eager_round('target'),
                                             steps=5, host=True),
                'round_layer_skip': step_profile(
                    torch, eager_round('layer_skip'), steps=5),
                'plain_step_graphed': step_profile(torch, plain_graphed,
                                                   steps=5),
                'plain_step': step_profile(torch, plain_step, steps=5)}
    launches_per_replay = {name: replay_launches(engines[name])
                           for name in ('target', 'layer_skip')}

    summary = dict(phase='engine_spec', card=smi, spec_k=SPEC_K,
                   requests=len(prompts), new_tokens=NEW_TOKENS,
                   slots=PAGED_SLOTS, num_blocks=PAGED_BLOCKS,
                   block_size=PAGED_BLOCK,
                   sampled_in_fallback_run=sum(1 for _, kw in mixed if kw),
                   ties=len(ties), lost_proposals_target=dict(
                       at_ties=sum(m['lost'] for m in lost
                                   if m['gap'] <= TIE),
                       otherwise=sum(m['lost'] for m in lost
                                     if m['gap'] > TIE)),
                   warmup=warm, graphs_vs_eager=graph_check,
                   launches_per_replay=launches_per_replay,
                   logits_max_abs_err=errs, round_host_ms=round_ms,
                   graph_device_ms=device_ms,
                   round_profile=profiles, launches=counts,
                   peak_mem_bytes=torch.cuda.max_memory_allocated())
    for name, run in runs.items():
        gen = sum(len(o) for o in run['outs'])
        res = dict(tokens=gen, wall_s=run['wall'],
                   tokens_per_s=gen / run['wall'],
                   decode_steps=run['stats']['decode_steps'])
        sp = run['stats'].get('spec')
        if sp:
            r = max(sp['rounds'], 1)
            res.update(sp, tokens_per_round=sp['emitted'] / r,
                       round_ms=(sp['draft_s'] + sp['verify_s']) / r * 1e3,
                       draft_ms=sp['draft_s'] / r * 1e3,
                       verify_ms=sp['verify_s'] / r * 1e3)
        summary[name] = res
    return summary, counts


def gather_case(torch, F, w, n, g, at):
    """The gather of ``n`` ids from the table ``w`` against its plain
    version, timed as `gather_times` times it: a case dict, also printed
    on a line of its own (phase ``gather_case``, ``at`` the path) with its
    time beside its bound, its share of the bound and ``F.embedding``'s
    time."""
    from paddle_tpu_torch.ops import embedding_ops
    rows, D = w.shape
    ids = torch.randint(0, rows, (n,), generator=g, device=w.device)
    err = max_err(torch, [embedding_ops.embedding_gather(w, ids)],
                  [embedding_ops._gather_ref(w, ids)])
    nbytes = (n + min(n, rows)) * D * 4 + n * 8
    ms, plain, library = gather_times(
        torch, F, embedding_ops, w, n,
        torch.Generator(device=w.device).manual_seed(98), nbytes)
    case = dict(n=n, table_rows=rows, max_abs_err=err, ms=ms,
                plain_ms=plain, library_ms=library,
                rotating_sets=rotation(nbytes),
                eager_ms=eager_ms(torch, lambda: embedding_ops
                                  .embedding_gather(w, ids), iters=10,
                                  warmup=2), **bound(nbytes, 0))
    case['share_of_bound'] = case['bound_ms'] / ms
    emit(dict(phase='gather_case', at=at, D=D, **{k: case[k] for k in (
        'n', 'table_rows', 'ms', 'bound_ms', 'share_of_bound', 'library_ms',
        'plain_ms', 'max_abs_err')}))
    return case


def check_lstm_gather(torch, F):
    """Phase 19's kernel: the gather of the word ids from the [5000, 128]
    table at each bucket's B 32 x L ids."""
    dev = torch.device('cuda', 0)
    g = torch.Generator(device=dev).manual_seed(1919)
    w = torch.randn((LSTM_VOCAB, LSTM_EMB), generator=g, device=dev) * 0.02
    cases = [gather_case(torch, F, w, LSTM_B * sl, g, 'stacked_lstm')
             for sl in LSTM_BUCKETS]
    for c in cases:
        check_bound('embedding_gather', c)
    out = dict(tolerance=0.0, cases=cases,
               max_abs_err=max(c['max_abs_err'] for c in cases))
    if out['max_abs_err'] > 0:
        raise AssertionError('the gather at the stacked_lstm shapes is off '
                             'its plain version by %g' % out['max_abs_err'])
    emit(dict(phase='stacked_lstm_kernel', name='embedding_gather', **out))
    return {'embedding_gather': out}


def check_train_kernels(torch, F, phase, cfg, shapes, n_rows, ce_shapes,
                        ffn_infer_rows=(), ffn=True):
    """Phases 5, 11 and 15b (d): the kernels a training step runs, but for
    flash attention, at one model's shapes: ``n_rows`` rows of
    ``cfg.d_model``, CE at each (rows, vocabulary) of ``ce_shapes``, Adam
    over the parameter ``shapes``, and the FFN (unless ``ffn`` is false: an
    AMP step stands it down) also at each of ``ffn_infer_rows`` as
    inference calls it (no mask, no pre1). Returns {kernel name: summary
    dict} as check_kernels does."""
    from paddle_tpu_torch.ops import ce_ops, nn_ops, optimizer_ops
    dev = torch.device('cuda', 0)
    g = torch.Generator(device=dev).manual_seed(4321)
    N, V, D = n_rows, cfg.vocab_size, cfg.d_model

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    def timed(fn, plain, library, nbytes, flops, calls=5, product_flops=0):
        return dict(ms=cuda_ms(torch, fn, calls=calls, replays=5),
                    eager_ms=eager_ms(torch, fn, iters=10, warmup=2),
                    plain_ms=cuda_ms(torch, plain, calls=calls, replays=5),
                    library_ms=library(),
                    **bound(nbytes, flops, product_flops))

    out = {}
    # the forward kernels of the decode path at the training step's row
    # count: the embedding gather (from every table the model has), the
    # LN-residual forward and the FFN tail (with its pre-scaled dropout
    # mask and pre1, as a training step calls it)
    cases = [gather_case(torch, F, randn(rows, D, scale=0.02), N, g, phase)
             for rows in [V] + ([cfg.type_vocab_size]
                                if hasattr(cfg, 'type_vocab_size') else [])]
    out['embedding_gather'] = dict(tolerance=0.0, cases=cases)
    x, r = randn(N, D), randn(N, D)
    sc, bi = 1.0 + randn(D, scale=0.1), randn(D, scale=0.1)
    err = max_err(torch, nn_ops._ln_res_fwd(x, r, sc, bi, 1e-5),
                  nn_ops._ln_res_ref(x, r, sc, bi, 1e-5))
    out['fused_ln_residual'] = dict(tolerance=1e-4, cases=[dict(
        n=N, D=D, max_abs_err=err, **timed(
            lambda: nn_ops._ln_res_fwd(x, r, sc, bi, 1e-5),
            lambda: nn_ops._ln_res_ref(x, r, sc, bi, 1e-5),
            lambda: cuda_ms(torch, lambda: F.layer_norm(
                x + r, (D,), sc, bi, 1e-5)),
            4 * N * D * 4 + 2 * D * 4 + 2 * N * 4, 9 * N * D, calls=20))])
    del x, r
    if ffn:
        out['fused_ffn'] = check_ffn(torch, F, cfg, g, N, ffn_infer_rows,
                                     randn, timed)
    torch.cuda.empty_cache()

    # CE: logits of an LM head's scale, labels in range but for some rows
    # that are ignored (-100) and two outside [0, V)
    fwd_cases, bwd_cases = [], []
    for n, v in ce_shapes:
        calls = 5 if n * v > 1 << 26 else 20
        x = randn(n, v, scale=2.0)
        lab = torch.randint(0, v, (n,), generator=g, device=dev)
        lab[::97] = -100
        lab[1] = v + 11
        lab[2] = -3
        ct = torch.full((n,), 1.0 / n, device=dev)   # the mean's cotangent
        loss, lse = ce_ops._ce_fwd(x, lab, -100)
        loss_r, lse_r = ce_ops._ce_fwd_ref(x, lab, -100)
        err = max_err(torch, [loss, lse], [loss_r, lse_r])
        safe = lab.clamp(0, v - 1)
        # the library call asserts on labels outside [0, V) other than -100
        lib_lab = torch.where((lab == -100) | (lab == safe), lab, safe)
        fwd_cases.append(dict(n=n, V=v, max_abs_err=err, **timed(
            lambda: ce_ops._ce_fwd(x, lab, -100),
            lambda: ce_ops._ce_fwd_ref(x, lab, -100),
            lambda: cuda_ms(torch, lambda: F.cross_entropy(
                x, lib_lab, reduction='none'), calls=calls, replays=5),
            n * v * 4 + n * 8 + 2 * n * 4, 4 * n * v, calls=calls)))
        dx = ce_ops._ce_bwd(x, lab, lse, ct, -100)
        dx_r = ce_ops._ce_bwd_ref(x, lab, lse, ct, -100)
        # a typical |dx| is p * ct ~ 1e-9 at the LM's shape, so an absolute
        # limit would pass almost anything: each element is held against
        # its own magnitude (an ignored row's 0 against 0, so any nonzero
        # there fails too)
        diff = (dx - dx_r).abs()
        err = float(diff.max())
        rel = float((diff / dx_r.abs().clamp_min(1e-30)).max())
        ignored = bool((dx[lab == -100] == 0).all())
        del dx, dx_r, diff
        one = -torch.ones((n, 1), device=dev)
        bwd_cases.append(dict(
            n=n, V=v, max_abs_err=err, max_rel_err=rel,
            ignored_rows_zero=ignored, **timed(
                lambda: ce_ops._ce_bwd(x, lab, lse, ct, -100),
                lambda: ce_ops._ce_bwd_ref(x, lab, lse, ct, -100),
                lambda: cuda_ms(torch, lambda: torch.softmax(
                    x, 1).scatter_add_(1, safe[:, None], one)
                    * ct[:, None], calls=calls, replays=5),
                2 * n * v * 4 + n * 8 + 2 * n * 4, 4 * n * v, calls=calls)))
        if not ignored:
            raise AssertionError('CE backward: an ignored row is not '
                                 'exactly 0')
        del x, loss, lse, loss_r, lse_r
    out['softmax_ce_fwd'] = dict(tolerance=1e-4, cases=fwd_cases)
    out['softmax_ce_bwd'] = dict(tolerance=1e-5, checked='max_rel_err',
                                 cases=bwd_cases)

    # LN-residual backward, from a real forward's stats
    sc = 1.0 + randn(D, scale=0.1)
    _, s, m, rs = nn_ops._ln_res_ref(randn(N, D), randn(N, D), sc,
                                     randn(D, scale=0.1), 1e-5)
    dy, ds = randn(N, D), randn(N, D)
    err = max_err(torch, [nn_ops._ln_res_bwd(s, m, rs, sc, dy, ds)],
                  [nn_ops._ln_res_bwd_ref(s, m, rs, sc, dy, ds)])
    zeros = torch.zeros_like(sc)
    case = dict(n=N, D=D, max_abs_err=err, **timed(
        lambda: nn_ops._ln_res_bwd(s, m, rs, sc, dy, ds),
        lambda: nn_ops._ln_res_bwd_ref(s, m, rs, sc, dy, ds),
        lambda: cuda_ms(torch, lambda: torch.ops.aten.native_layer_norm_backward(
            dy, s, [D], m[:, None], rs[:, None], sc, zeros,
            [True, True, True])),
        4 * N * D * 4 + 2 * N * 4 + D * 4, 12 * N * D, calls=20))
    out['fused_ln_residual_bwd'] = dict(tolerance=1e-4, cases=[case])

    # multi-tensor Adam over the model's parameter shapes, as at step 4
    # (the beta powers advanced three times)
    shapes = list(shapes)
    numel = sum(int(np.prod(sh)) for sh in shapes)
    p = [randn(*sh, scale=0.02) for sh in shapes]
    gr = [randn(*sh, scale=1e-3) for sh in shapes]
    m1 = [randn(*sh, scale=1e-4) for sh in shapes]
    m2 = [randn(*sh, scale=1e-4).square() for sh in shapes]
    b1p = [torch.full((1,), 0.9 ** 4, device=dev) for _ in shapes]
    b2p = [torch.full((1,), 0.999 ** 4, device=dev) for _ in shapes]
    lr = torch.full((1,), 1e-4, device=dev)
    state = [p, m1, m2, b1p, b2p]
    ref = [[t.clone() for t in ts] for ts in state]
    optimizer_ops.fused_adam(p, gr, m1, m2, b1p, b2p, lr)
    optimizer_ops._fused_adam_ref(ref[0], gr, ref[1], ref[2], ref[3], ref[4],
                                  lr, 0.9, 0.999, 1e-8)
    pairs = [(a, b) for got, want in zip(state, ref)
             for a, b in zip(got, want)]
    err = max(float((a - b).abs().max()) for a, b in pairs)
    # relative: the largest difference over the largest magnitude, per
    # state tensor
    rel = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
              for a, b in pairs)
    lib_p = [t.clone().requires_grad_() for t in p]
    for t, gt in zip(lib_p, gr):
        t.grad = gt.clone()
    # capturable, so that its step replays in a CUDA graph like the others
    lib = torch.optim.Adam(lib_p, lr=1e-4, fused=True, capturable=True)
    case = dict(tensors=len(shapes), numel=numel, max_abs_err=err,
                max_rel_err=rel, **timed(
                    lambda: optimizer_ops.fused_adam(p, gr, m1, m2, b1p, b2p,
                                                     lr),
                    lambda: optimizer_ops._fused_adam_ref(
                        ref[0], gr, ref[1], ref[2], ref[3], ref[4], lr, 0.9,
                        0.999, 1e-8),
                    lambda: cuda_ms(torch, lib.step, calls=5, replays=5),
                    28 * numel + 2 * 2 * 4 * len(shapes) + 4, 12 * numel))
    out['fused_adam'] = dict(tolerance=1e-6, checked='max_rel_err',
                             cases=[case])
    del p, gr, m1, m2, ref, pairs, lib_p, lib

    finish_kernel_checks(phase, out)
    torch.cuda.empty_cache()
    return out


def check_ffn(torch, F, cfg, g, N, infer_rows, randn, timed):
    """check_train_kernels' FFN cases: the training step's call at ``N``
    rows (mask and pre1), then each of ``infer_rows`` as inference calls it
    (neither)."""
    from paddle_tpu_torch.ops import ffn_ops
    dev = torch.device('cuda', 0)
    D, d_ff = cfg.d_model, cfg.d_ff
    w1, b1 = randn(D, d_ff, scale=0.02), randn(d_ff, scale=0.02)
    w2, b2 = randn(d_ff, D, scale=0.02), randn(D, scale=0.02)
    mask = (torch.rand((N, D), generator=g, device=dev) < 0.9).float() / 0.9
    cases = []
    for n, m, want_pre1 in [(N, mask, True)] + [
            (n, None, False) for n in infer_rows]:
        x = randn(n, D)
        got = ffn_ops._ffn_fwd(x, w1, b1, w2, b2, m, want_pre1)
        ref = ffn_ops._ffn_ref(x, w1, b1, w2, b2, m)
        err = max_err(torch, got[:1 + want_pre1], ref[:1 + want_pre1])
        del got, ref

        def lib(x=x, m=m):
            y = F.gelu(x @ w1 + b1) @ w2 + b2
            return y * m if m is not None else y

        cases.append(dict(
            n=n, d=D, d_ff=d_ff, masked=m is not None, pre1=want_pre1,
            route=ffn_ops._plan(n, D, d_ff, D)[0], max_abs_err=err,
            deterministic=same_bits(torch, lambda: ffn_ops._ffn_fwd(
                x, w1, b1, w2, b2, m, want_pre1)), **timed(
                lambda: ffn_ops._ffn_fwd(x, w1, b1, w2, b2, m, want_pre1),
                lambda: ffn_ops._ffn_ref(x, w1, b1, w2, b2, m),
                lambda: cuda_ms(torch, lib, calls=5, replays=5),
                (2 * n * D + D * d_ff + d_ff + d_ff * D + D
                 + want_pre1 * n * d_ff + (m is not None) * n * D) * 4,
                8 * n * d_ff, product_flops=4 * n * D * d_ff)))
        del x
        if not cases[-1]['deterministic']:
            raise AssertionError('fused_ffn gave other bits on a second '
                                 'call at N %d' % n)
    return dict(tolerance=1e-4, cases=cases)


def finish_kernel_checks(phase, out):
    """Emit every case of ``out`` and raise where a kernel's checked error
    exceeds its tolerance or its time reads under its bound."""
    for name, res in out.items():
        key = res.setdefault('checked', 'max_abs_err')
        for k in {'max_abs_err', key}:
            res[k] = max(c[k] for c in res['cases'])
        for c in res['cases']:
            emit(dict(phase=phase, name=name, checked=key,
                      tolerance=res['tolerance'], **c))
            check_bound(name, c)
        if not res[key] <= res['tolerance']:
            raise AssertionError('%s disagrees with its plain version: %s '
                                 '%g > %g' % (name, key, res[key],
                                              res['tolerance']))


def kernel_names(torch, fn):
    """The sorted names of the device kernels one call of ``fn`` runs, by
    torch.profiler; None where it recorded no device kernel (then they
    were not measured)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key[:100] for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA}) or None


def sdpa_yardsticks(torch, F, sdpa, q4, k4, v4, mask4, causal):
    """What bf16 SDPA's time stands for: the device kernels one call of it
    runs (``library_kernels``: on an H100 cuDNN's wgmma kernel), and the
    time of its FlashAttention-2 backend forced (``library_fa2_ms``, an
    mma.sync kernel like this repo's; None with a mask, which FA2 does not
    take)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    names = kernel_names(torch, lambda: sdpa(q4, k4, v4))
    fa2 = None
    if mask4 is None:
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            fa2 = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=causal), calls=10, replays=5)
    return dict(library_kernels=names, library_fa2_ms=fa2)


def flash_shapes(torch, low):
    """The shapes of phases 8 (``low`` False) and 13 (``low``, the AMP
    step's B 64): the LM training shape, causal, and BERT's, with its
    key-padding bias [B, L] on the CPU (key lengths drawn in 32..128, batch
    element 0 wholly padded) and the visible (query, key) pairs of each;
    phase 13 also ``lm_long_seq8k``'s (B 2 x 8 heads, L 8192, causal); both
    last ``lm_dh256``'s (B 32 x 4 heads, L 512, dh 256, causal)."""
    lens = np.random.RandomState(11).randint(32, 129, size=BERT_INFER_B)
    lens[0] = 0                       # one batch element wholly padded
    bias = torch.zeros(BERT_INFER_B, 128)
    for i, n in enumerate(lens):
        bias[i, n:] = -1e9
    lm_b = AMP_TRAIN_B if low else TRAIN_B
    out = [dict(shape='lm_train', B=lm_b, H=8, L=512, dh=64, causal=True,
                bias=None, pairs=lm_b * 8 * 512 * 513 // 2),
           dict(shape='bert', B=BERT_INFER_B, H=12, L=128, dh=64,
                causal=False, bias=bias, pairs=12 * 128 * int(lens.sum()))]
    if low:
        L = SEQ8K['seq_len']
        out.append(dict(shape='lm_long_seq8k', B=SEQ8K_B, H=SEQ8K['n_head'],
                        L=L, dh=SEQ8K['d_model'] // SEQ8K['n_head'],
                        causal=True, bias=None,
                        pairs=SEQ8K_B * SEQ8K['n_head'] * L * (L + 1) // 2))
    H, L = LM_DH256['n_head'], LM_DH256['seq_len']
    out.append(dict(shape='lm_dh256', B=LM_DH256_B, H=H, L=L,
                    dh=LM_DH256['d_model'] // H, causal=True, bias=None,
                    pairs=LM_DH256_B * H * L * (L + 1) // 2))
    return out


def sdpa_bwd_yardsticks(torch, F, sdpa, q4, k4, v4, do4, mask4, causal):
    """What the time of bf16 SDPA's backward stands for: the device kernels
    one backward call runs (``library_kernels``), and the backward's time
    with SDPA's FlashAttention-2 backend forced (``library_fa2_ms``, an
    mma.sync kernel like this repo's; None with a mask, which FA2 does not
    take)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    leaves = [t.detach().clone().requires_grad_() for t in (q4, k4, v4)]
    out = sdpa(*leaves)
    names = kernel_names(torch, lambda: torch.autograd.grad(out, leaves, do4))
    del out, leaves
    fa2 = None
    if mask4 is None:
        def fwd(a, b, c):
            return F.scaled_dot_product_attention(a, b, c, is_causal=causal)
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            fa2 = backward_ms(torch, fwd, (q4, k4, v4), do4)
    return dict(library_kernels=names, library_fa2_ms=fa2)


def f32_flash_rows(bh, L, parts):
    """Rows a block (16 a warp) of a float32 flash kernel's launch with
    ``parts`` blocks a row tile (at dh 256 the forward's and dQ's 2, dK/dV's
    4; else 1): 64 where that gives each of the card's 132 SMs a block,
    else 32, else 16."""
    for rows in (64, 32):
        if bh * parts * -(-L // rows) >= 132:
            return rows
    return 16


def check_flash_kernels(torch, F, dtype=None, ptxas=None):
    """Phases 8 and 13: the three flash kernels at the LM training shape,
    at BERT's (with the key-padding bias) and at ``lm_dh256``'s, on float32
    operands (phase 8) or on bf16 ones (phase 13, ``dtype`` bf16: the bf16
    kernels at the AMP step's B 64). Each kernel's cases also name their
    plan and, from ``ptxas`` (``ptxas_report`` of the build), the registers
    and spilled bytes of the instantiation that plan launches; no
    instantiation of a bf16 flash kernel may spill, nor any dh-256 one of
    a float32 flash kernel. Returns {kernel name: summary}."""
    from paddle_tpu_torch.ops import attention_ops as A
    dtype = dtype or torch.float32
    low = dtype == torch.bfloat16
    fwd_ptxas = (ptxas or {}).get(
        'flash_attn_bf16_fwd' if low else 'flash_attn_fwd', {})
    bwd_ptxas = (ptxas or {}).get(
        'flash_attn_bf16_bwd' if low else 'flash_attn_bwd', {})
    suffix = '_bf16<' if low else '<'
    dq_ptxas, dkv_ptxas = ({k: r for k, r in bwd_ptxas.items()
                            if k.startswith(name + suffix)}
                           for name in ('flash_bwd_dq', 'flash_bwd_dkv'))
    for what, rep in (('forward', fwd_ptxas), ('dQ', dq_ptxas),
                      ('dK/dV', dkv_ptxas)):
        spilled = {k: r for k, r in rep.items()
                   if (r[1] or r[2]) and (low or '<256,' in k)}
        if spilled:
            raise AssertionError('the %s %s spills: %s'
                                 % ('bf16' if low else 'float32', what,
                                    spilled))
    dev = torch.device('cuda', 0)
    g = torch.Generator(device=dev).manual_seed(777)
    shapes = flash_shapes(torch, low)
    names = AMP_FLASH_KERNELS if low else FLASH_KERNELS
    # float32: O and LSE within 1e-4 absolute, each gradient within 1e-4 of
    # its largest magnitude; bf16: O, dQ, dK and dV within 1e-2 of each
    # one's largest magnitude (one bf16 step is 2^-8 of an element), LSE
    # within 1e-5 absolute (checked apart)
    tol = 1e-2 if low else 1e-4
    out = {n: dict(tolerance=tol, cases=[]) for n in names}
    for n in (names if low else names[1:]):
        out[n]['checked'] = 'max_rel_err'
    for sh in shapes:
        B, H, L, dh, causal, bias = (sh[k] for k in (
            'B', 'H', 'L', 'dh', 'causal', 'bias'))
        bias = None if bias is None else bias.to(dev)
        bh, scale = B * H, dh ** -0.5
        q, k, v, do = (torch.randn((bh, L, dh), generator=g,
                                   device=dev).to(dtype) for _ in range(4))
        args = (scale, causal, bias, H)
        o, lse = A._flash_fwd(q, k, v, *args)
        o_ref, lse_ref = A._attention_ref(q, k, v, *args)
        delta = A._delta(do, o)
        dq = A._flash_bwd_dq(q, k, v, do, lse, delta, *args)
        dk, dv = A._flash_bwd_dkv(q, k, v, do, lse, delta, *args)
        dq_ref = A._bwd_dq_ref(q, k, v, do, lse, delta, *args)
        dk_ref, dv_ref = A._bwd_dkv_ref(q, k, v, do, lse, delta, *args)
        torch.cuda.synchronize()
        # LSE is compared on the rows that keep a key: in a wholly padded
        # row it is about -1e9, where f32 steps by 64
        live = torch.ones(bh, dtype=torch.bool, device=dev) if bias is None \
            else (bias > -1e8).any(dim=1).repeat_interleave(H)
        padded_zero = None
        if bias is not None:
            padded_zero = not any(bool(t[~live].any())
                                  for t in (o, dq, dk, dv))
            if not padded_zero or int((~live).sum()) != H:
                raise AssertionError('the wholly padded element is not '
                                     'exactly 0 in O, dQ, dK and dV')
        lse_err = float((lse - lse_ref)[live].abs().max())
        if low and not lse_err <= 1e-5:
            raise AssertionError('%s: LSE differs from its plain version by '
                                 '%g > 1e-5' % (names[0], lse_err))

        def rel(got, want):
            return float((got.float() - want.float()).abs().max()
                         / want.float().abs().max())

        common = dict(shape=sh['shape'], bh=bh, L=L, dh=dh, causal=causal,
                      biased=bias is not None, visible_pairs=sh['pairs'],
                      padded_element_exactly_zero=padded_zero)
        size = 2 if low else 4
        mat, row = bh * L * dh * size, bh * L * 4
        extra = 0 if bias is None else bias.numel() * 4
        q4, k4, v4, do4 = (t.view(B, H, L, dh) for t in (q, k, v, do))
        mask4 = None if bias is None else bias.view(B, 1, 1, L).to(dtype)

        def sdpa(a, b, c):
            return F.scaled_dot_product_attention(a, b, c, attn_mask=mask4,
                                                  is_causal=causal)

        # SDPA's backward (dQ, dK and dV in one call): device time from CUDA
        # graph replays, like the kernels', and the eager rate beside it
        leaves = [t.detach().clone().requires_grad_() for t in (q4, k4, v4)]
        lib_out = sdpa(*leaves)
        lib_bwd = dict(
            library_ms=backward_ms(torch, sdpa, (q4, k4, v4), do4),
            library_eager_ms=eager_ms(torch, lambda: torch.autograd.grad(
                lib_out, leaves, do4, retain_graph=True), iters=20, warmup=3),
            library_covers='dQ, dK and dV in one call')
        del lib_out, leaves
        dq_extra, dkv_extra = {}, {}
        if not low:
            # the plan (rows a block, 16 a warp) and the instantiations
            # flash_bwd_{dq,dkv}<dh, warps>
            for res, rep, kernel, parts in ((dq_extra, dq_ptxas, 'dq', 2),
                                            (dkv_extra, dkv_ptxas, 'dkv', 4)):
                rows = f32_flash_rows(bh, L, parts if dh > 128 else 1)
                kname = 'flash_bwd_%s<%d, %d>' % (kernel, dh, rows // 16)
                regs = rep.get(kname, [None] * 3)
                res.update(plan=dict(rows_block=rows, rows_warp=16),
                           kernel=kname, registers=regs[0],
                           spill_store_bytes=regs[1], spill_load_bytes=regs[2])
        if low:
            dkv_extra = sdpa_bwd_yardsticks(torch, F, sdpa, q4, k4, v4, do4,
                                            mask4, causal)
            # the plan (query rows or keys a block, 16 a warp) and the
            # instantiations flash_bwd_{dq,dkv}_bf16<dh, warps, biased,
            # scaled dS> (0: dh^-0.5 = 0.125 is a power of two)
            rows = A._bf16_bwd_plan(bh, L, dh)
            for res, rep, kernel in ((dq_extra, dq_ptxas, 'dq'),
                                     (dkv_extra, dkv_ptxas, 'dkv')):
                kname = 'flash_bwd_%s_bf16<%d, %d, %d, 0>' % (
                    kernel, dh, rows // 16, bias is not None)
                regs = rep.get(kname, [None] * 3)
                res.update(plan=dict(rows_block=rows, rows_warp=16),
                           kernel=kname, registers=regs[0],
                           spill_store_bytes=regs[1], spill_load_bytes=regs[2])

        def case(fn, plain, library, nbytes, flops, split_flops, **errs):
            # every flop counted here is a matrix product's; at dh 256 the
            # column split does ``extra`` more (the score products twice)
            key = 'bf16_flops' if low else 'product_flops'
            out = dict(common, ms=cuda_ms(torch, fn, calls=10, replays=5),
                       eager_ms=eager_ms(torch, fn, iters=10, warmup=2),
                       plain_ms=cuda_ms(torch, plain, calls=5, replays=5),
                       **library, **bound(nbytes, 0, **{key: flops}),
                       **errs)
            out['share_of_bound'] = out['bound_ms'] / out['ms']
            if dh > 128:
                split = bound(nbytes, 0, **{key: flops + split_flops})
                out.update(split_extra_flops=split_flops,
                           bound_split_ms=split['bound_ms'],
                           bound_split_by=split['bound_by'])
            return out

        fwd_errs = dict(max_abs_err=max(float((o.float() - o_ref.float())
                                              .abs().max()), lse_err))
        fwd_library = dict(library_ms=cuda_ms(torch, lambda: sdpa(q4, k4, v4),
                                              calls=10, replays=5))
        if low:
            fwd_errs.update(max_rel_err=rel(o, o_ref), lse_abs_err=lse_err)
            fwd_library.update(sdpa_yardsticks(torch, F, sdpa, q4, k4, v4,
                                               mask4, causal))
            # the plan the forward took: query rows a block and a warp,
            # whether its scores are the raw products, and its instantiation
            # flash_fwd_bf16<dh, warps, row tiles a warp, raw>
            rows_block, rows_warp, raw = A._bf16_fwd_plan(
                bh, L, dh, causal, bias is not None, scale)
            kname = 'flash_fwd_bf16<%d, %d, %d, %d>' % (
                dh, rows_block // rows_warp, rows_warp // 16, raw)
            regs = fwd_ptxas.get(kname, [None] * 3)
            fwd_errs.update(plan=dict(rows_block=rows_block,
                                      rows_warp=rows_warp, raw=raw),
                            kernel=kname, registers=regs[0],
                            spill_store_bytes=regs[1],
                            spill_load_bytes=regs[2])
        else:
            rows = f32_flash_rows(bh, L, 2 if dh > 128 else 1)
            kname = 'flash_fwd_tc<%d, %d>' % (dh, rows // 16)
            regs = fwd_ptxas.get(kname, [None] * 3)
            fwd_errs.update(plan=dict(rows_block=rows, rows_warp=16),
                            kernel=kname, registers=regs[0],
                            spill_store_bytes=regs[1],
                            spill_load_bytes=regs[2])
        out[names[0]]['cases'].append(case(
            lambda: A._flash_fwd(q, k, v, *args),
            lambda: A._attention_ref(q, k, v, *args),
            fwd_library,
            4 * mat + row + extra, 4 * dh * sh['pairs'], 2 * dh * sh['pairs'],
            deterministic=same_bits(torch, lambda: A._flash_fwd(
                q, k, v, *args)), **fwd_errs))
        if low:
            fwd = out[names[0]]['cases'][-1]
            fwd['ms_over_library'] = fwd['ms'] / fwd['library_ms']
            if fwd['library_fa2_ms']:
                fwd['ms_over_fa2'] = fwd['ms'] / fwd['library_fa2_ms']
        out[names[1]]['cases'].append(case(
            lambda: A._flash_bwd_dq(q, k, v, do, lse, delta, *args),
            lambda: A._bwd_dq_ref(q, k, v, do, lse, delta, *args),
            lib_bwd, 5 * mat + 2 * row + extra, 6 * dh * sh['pairs'],
            4 * dh * sh['pairs'], **dq_extra,
            max_abs_err=float((dq.float() - dq_ref.float()).abs().max()),
            max_rel_err=rel(dq, dq_ref),
            largest_magnitude=dict(dq=float(dq_ref.float().abs().max())),
            deterministic=same_bits(torch, lambda: A._flash_bwd_dq(
                q, k, v, do, lse, delta, *args))))
        out[names[2]]['cases'].append(case(
            lambda: A._flash_bwd_dkv(q, k, v, do, lse, delta, *args),
            lambda: A._bwd_dkv_ref(q, k, v, do, lse, delta, *args),
            lib_bwd, 6 * mat + 2 * row + extra, 8 * dh * sh['pairs'],
            (4 if low else 8) * dh * sh['pairs'], **dkv_extra,
            max_abs_err=max(float((dk.float() - dk_ref.float()).abs().max()),
                            float((dv.float() - dv_ref.float()).abs().max())),
            max_rel_err=max(rel(dk, dk_ref), rel(dv, dv_ref)),
            largest_magnitude=dict(dk=float(dk_ref.float().abs().max()),
                                   dv=float(dv_ref.float().abs().max())),
            deterministic=same_bits(torch, lambda: A._flash_bwd_dkv(
                q, k, v, do, lse, delta, *args))))
        if low:
            # the backward pair (dQ + dK/dV) against SDPA's backward, which
            # yields dQ, dK and dV in one call
            dkv = out[names[2]]['cases'][-1]
            dkv['pair_ms'] = out[names[1]]['cases'][-1]['ms'] + dkv['ms']
            dkv['ms_over_library'] = dkv['pair_ms'] / dkv['library_ms']
            if dkv['library_fa2_ms']:
                dkv['ms_over_fa2'] = dkv['pair_ms'] / dkv['library_fa2_ms']
        for name in names:
            if not out[name]['cases'][-1]['deterministic']:
                raise AssertionError('%s gave other bits on a second call at '
                                     'the %s shape' % (name, sh['shape']))
        del q, k, v, do, o, lse, o_ref, lse_ref, dq, dk, dv, dq_ref, dk_ref
        del dv_ref, q4, k4, v4, do4
        torch.cuda.empty_cache()
    finish_kernel_checks('amp_flash_kernel' if low else 'flash_kernel', out)
    torch.cuda.empty_cache()
    return out


def check_head_widths(torch):
    """Phase 13b: the three float32 flash kernels and the three bf16 ones
    at head widths between their instantiations (8, 48, 80, 96, 160, 192),
    which the wrappers zero-pad to the next one (16, 64, 128, 128, 256,
    256), at 256 (each head's output columns split over two blocks), and
    the wide kernels at 257 and 320 (padded to 384), on a small
    causal shape (B 4, H 2, L 200) with a key-padding bias cutting the
    elements to 200, 173, 140 and 101 keys: each held to its plain version
    at the true width within phases 8's and 13's tolerances (float32: O and
    LSE 1e-4 absolute, each gradient 1e-4 of its largest magnitude; bf16:
    O, dQ, dK and dV 1e-2 of theirs, LSE 1e-5), each launched once a
    call."""
    from paddle_tpu_torch.ops import attention_ops as A
    from paddle_tpu_torch.ops import kernel_tier as kt
    dev = torch.device('cuda', 0)
    g = torch.Generator(device=dev).manual_seed(31)
    B, H, L = 4, 2, 200
    bias = torch.zeros(B, L, device=dev)
    for i, keep in enumerate((200, 173, 140, 101)):
        bias[i, keep:] = -1e9
    cases = []
    for dtype, names, tol in (
            (torch.float32, FLASH_KERNELS, 1e-4),
            (torch.bfloat16, AMP_FLASH_KERNELS, 1e-2)):
        for dh in (8, 48, 80, 96, 160, 192, 256, 257, 320):
            q, k, v, do = (torch.randn((B * H, L, dh), generator=g,
                                       device=dev).to(dtype)
                           for _ in range(4))
            args = (dh ** -0.5, True, bias, H)
            before = kt.launch_counts()
            o, lse = A._flash_fwd(q, k, v, *args)
            dq, dk, dv = A._flash_bwd(q, k, v, o, lse, do, *args)
            torch.cuda.synchronize()
            after = kt.launch_counts()
            counted = WIDE_FLASH_KERNELS if dh > 256 else names
            o_ref, lse_ref = A._attention_ref(q, k, v, *args)
            want = A._flash_bwd_ref(q, k, v, o, lse, do, *args)
            rel = lambda a, b: float((a.float() - b.float()).abs().max() /
                                     b.float().abs().max().clamp_min(1.0))
            case = dict(dtype=str(dtype).split('.')[-1], dh=dh,
                        width=A._kernel_width(dh),
                        o_err=float((o.float() - o_ref.float()).abs().max()),
                        o_rel_err=rel(o, o_ref),
                        lse_err=float((lse - lse_ref).abs().max()),
                        dq_rel_err=rel(dq, want[0]),
                        dk_rel_err=rel(dk, want[1]),
                        dv_rel_err=rel(dv, want[2]),
                        launches=[after[n] - before[n] for n in counted])
            cases.append(case)
            o_key = 'o_rel_err' if dtype == torch.bfloat16 else 'o_err'
            lse_tol = 1e-5 if dtype == torch.bfloat16 else 1e-4
            if not (case[o_key] <= tol and case['lse_err'] <= lse_tol and
                    max(case['dq_rel_err'], case['dk_rel_err'],
                        case['dv_rel_err']) <= tol and
                    case['launches'] == [1, 1, 1]):
                emit(dict(phase='flash_head_widths', cases=cases))
                raise AssertionError('flash kernels at head width %d (%s): '
                                     '%s' % (dh, dtype, case))
    return dict(phase='flash_head_widths', shape=dict(B=B, H=H, L=L),
                causal=True, keys_kept=[200, 173, 140, 101], cases=cases)


def check_wide_flash_kernels(torch, F, ptxas):
    """Phase 13c: the three wide flash kernels, float32 and bf16, at
    WIDE_SHAPE (module docstring). Returns {kernel name: summary}, one
    case a dtype (float32 first)."""
    from paddle_tpu_torch.ops import attention_ops as A
    spilled = {k: r for k, r in ptxas.get('flash_attn_wide', {}).items()
               if r[1] or r[2]}
    if spilled:
        raise AssertionError('the wide flash kernels spill: %s' % spilled)
    dev = torch.device('cuda', 0)
    g = torch.Generator(device=dev).manual_seed(2323)
    B, H, L, dh = (WIDE_SHAPE[k] for k in ('B', 'H', 'L', 'dh'))
    bh, scale, causal = B * H, dh ** -0.5, True
    pairs = bh * L * (L + 1) // 2
    chunks = dh // 128
    groups = -(-chunks // 4)  # the column groups, one a block
    out = {n: dict(tolerance=1e-2, checked='max_rel_err', cases=[])
           for n in WIDE_FLASH_KERNELS}
    for dtype in (torch.float32, torch.bfloat16):
        low = dtype == torch.bfloat16
        q, k, v, do = (torch.randn((bh, L, dh), generator=g,
                                   device=dev).to(dtype) for _ in range(4))
        args = (scale, causal, None, H)
        o, lse = A._flash_fwd(q, k, v, *args)
        o_ref, lse_ref = A._attention_ref(q, k, v, *args)
        delta = A._delta(do, o)
        dq = A._flash_bwd_dq(q, k, v, do, lse, delta, *args)
        dk, dv = A._flash_bwd_dkv(q, k, v, do, lse, delta, *args)
        dq_ref = A._bwd_dq_ref(q, k, v, do, lse, delta, *args)
        dk_ref, dv_ref = A._bwd_dkv_ref(q, k, v, do, lse, delta, *args)
        torch.cuda.synchronize()

        def rel(got, want):
            return float((got.float() - want.float()).abs().max()
                         / want.float().abs().max())

        q4, k4, v4, do4 = (t.view(B, H, L, dh) for t in (q, k, v, do))

        def sdpa(a, b, c):
            return F.scaled_dot_product_attention(a, b, c, is_causal=causal)

        # SDPA under whichever backend takes dh 512, named by its kernels
        fwd_lib = dict(library_ms=cuda_ms(torch, lambda: sdpa(q4, k4, v4),
                                          calls=10, replays=5),
                       library_kernels=kernel_names(
                           torch, lambda: sdpa(q4, k4, v4)))
        leaves = [t.detach().clone().requires_grad_() for t in (q4, k4, v4)]
        lib_out = sdpa(*leaves)
        bwd_lib = dict(library_ms=backward_ms(torch, sdpa, (q4, k4, v4), do4),
                       library_covers='dQ, dK and dV in one call',
                       library_kernels=kernel_names(
                           torch, lambda: torch.autograd.grad(
                               lib_out, leaves, do4, retain_graph=True)))
        del lib_out, leaves
        size = 2 if low else 4
        mat, row = bh * L * dh * size, bh * L * 4
        common = dict(shape='flash_wide_' + ('bf16' if low else 'f32'),
                      dtype=str(dtype).split('.')[-1], bh=bh, L=L, dh=dh,
                      causal=causal, visible_pairs=pairs,
                      column_chunks=chunks)

        def case(fn, plain, library, nbytes, flops, repeated, **errs):
            key = 'bf16_flops' if low else 'product_flops'
            res = dict(common, ms=cuda_ms(torch, fn, calls=3, replays=3),
                       eager_ms=eager_ms(torch, fn, iters=5, warmup=1),
                       plain_ms=cuda_ms(torch, plain, calls=2, replays=3),
                       **library, **bound(nbytes, 0, **{key: flops}), **errs)
            # every flop at the CUDA cores' rate; and the flops the column
            # groups add: the score products (and dP) once a group
            res['bound_simt_ms'] = max(nbytes / PEAK_BYTES_PER_S,
                                       flops / PEAK_F32_FLOPS) * 1e3
            res['kernel_flops'] = flops + repeated
            res['share_of_bound'] = res['bound_ms'] / res['ms']
            res['share_of_simt_bound'] = res['bound_simt_ms'] / res['ms']
            res['ms_over_library'] = res['ms'] / res['library_ms']
            return res

        lse_err = float((lse - lse_ref).abs().max())
        o_err = float((o.float() - o_ref.float()).abs().max())
        errs = (dict(max_abs_err=max(o_err, lse_err),
                     max_rel_err=rel(o, o_ref), lse_abs_err=lse_err),
                dict(max_abs_err=float((dq.float() - dq_ref.float()).abs()
                                       .max()),
                     max_rel_err=rel(dq, dq_ref)),
                dict(max_abs_err=max(float((dk.float() - dk_ref.float())
                                           .abs().max()),
                                     float((dv.float() - dv_ref.float())
                                           .abs().max())),
                     max_rel_err=max(rel(dk, dk_ref), rel(dv, dv_ref))))
        calls = (
            (lambda: A._flash_fwd(q, k, v, *args),
             lambda: A._attention_ref(q, k, v, *args), fwd_lib,
             4 * mat + row, 4 * dh * pairs, 2 * dh * pairs * (groups - 1)),
            (lambda: A._flash_bwd_dq(q, k, v, do, lse, delta, *args),
             lambda: A._bwd_dq_ref(q, k, v, do, lse, delta, *args), bwd_lib,
             5 * mat + 2 * row, 6 * dh * pairs, 4 * dh * pairs * (groups - 1)),
            (lambda: A._flash_bwd_dkv(q, k, v, do, lse, delta, *args),
             lambda: A._bwd_dkv_ref(q, k, v, do, lse, delta, *args), bwd_lib,
             6 * mat + 2 * row, 8 * dh * pairs, 4 * dh * pairs * (groups - 1)))
        for i, name in enumerate(WIDE_FLASH_KERNELS):
            fn, plain, lib, nbytes, flops, repeated = calls[i]
            res = case(fn, plain, lib, nbytes, flops, repeated, **errs[i],
                       deterministic=same_bits(torch, fn))
            res['case_tolerance'] = 1e-2 if low else 1e-4
            out[name]['cases'].append(res)
            # float32: O and LSE 1e-4 absolute, gradients 1e-4 of their
            # largest magnitude; bf16: 1e-2 of it, LSE 1e-5 absolute
            err = o_err if (i == 0 and not low) else res['max_rel_err']
            if not (err <= res['case_tolerance'] and res['deterministic'] and
                    lse_err <= (1e-5 if low else 1e-4)):
                emit(dict(phase='wide_flash_kernel', name=name, **res))
                raise AssertionError('%s (%s) off its plain version or not '
                                     'repeatable: %g' % (name, dtype, err))
        del q, k, v, do, o, lse, o_ref, lse_ref, dq, dk, dv, dq_ref, dk_ref
        del dv_ref, q4, k4, v4, do4
        torch.cuda.empty_cache()
    finish_kernel_checks('wide_flash_kernel', out)
    return out


def run_flash_wide(torch, kt, smi):
    """Phase 13c's path (module docstring): the flash_wide holds, float32
    and AMP, then LARGE_STEPS timed ``run()`` steps of each at the hold's
    batch: step ms, device ms and the wide kernels' share of it (by
    torch.profiler). Returns {path: launch counts of the hold's card
    steps}."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models.transformer import LMConfig
    exe = fluid.Executor()
    cfg = LMConfig(**FLASH_WIDE)
    by_path = {}
    for amp, path, idle in (
            (False, 'flash_wide', FLASH_KERNELS + AMP_FLASH_KERNELS),
            (True, 'flash_wide_amp', AMP_IDLE_KERNELS + AMP_FLASH_KERNELS)):
        _, by_path[path] = lm_program_hold(torch, kt, fluid, smi, cfg, amp,
                                           path, phase='flash_wide_hold')
        torch.cuda.empty_cache()
        main, startup, _, loss = build_program(fluid, cfg, amp=amp)
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        step = program_step(exe, main, lm_feed(
            torch, cfg, DH256_HOLD_B, 23, exe.device), loss, scope)
        timed, _ = program_timing(
            torch, kt, step, LARGE_STEPS, program_step_launches(cfg, amp=amp),
            PATH_KERNELS[path], idle)
        # every wide kernel of one more step, the forward too (it may fall
        # out of the profile's top kernels)
        prof = step_profile(torch, step, steps=1,
                            kernel_shares={'wide': 'flash_wide'})
        wide = prof['kernel_shares']['wide']
        emit(dict(phase='flash_wide_train', path=path, card=smi, amp=amp,
                  batch=DH256_HOLD_B, head_width=cfg.d_model // cfg.n_head,
                  wide_kernels_ms=wide,
                  wide_share_of_device=wide / prof['device_ms_per_step'],
                  **timed))
        del scope, main, startup
        torch.cuda.empty_cache()
    return by_path


def run_optest_replay(torch, smi):
    """Phase 23 (module docstring). Returns the summary line."""
    from tools import torch_optest
    t0 = time.perf_counter()
    results, by_op = torch_optest.replay_all('cuda')
    seconds = time.perf_counter() - t0
    for t in sorted(by_op):
        emit(dict(phase='optest_replay_op', op=t, cases=by_op[t][0],
                  worst_viol=by_op[t][1]))
    status = [st for st, _ in results.values()]
    failed = {n: d for n, (st, d) in results.items() if st == 'fail'}
    out = dict(phase='optest_replay', card=smi, cases=len(results),
               passed=status.count('pass'), skipped=status.count('skip'),
               failed=sorted(failed), op_types=len(by_op), seconds=seconds)
    emit(out)
    if failed:
        raise AssertionError('recorded op cases fail on the card: %s'
                             % {n: str(d)[:300] for n, d in failed.items()})
    return out


def train_step_grads(torch, cfg, params, tok, lab, dev, amp=False):
    """(loss, {name: gradient on the CPU}, seconds) of one forward and
    backward of the LM on ``dev`` (bf16-marked with ``amp``)."""
    from paddle_tpu_torch.contrib import mixed_precision
    from paddle_tpu_torch.models.transformer import TransformerLM
    model = TransformerLM(cfg, {k: v.to(dev) for k, v in params.items()},
                          cfg.seq_len)
    if amp:
        mixed_precision.rewrite_model_bf16(model)
    t = time.perf_counter()
    loss = model.loss(tok.to(dev), lab.to(dev))
    loss.backward()
    grads = {n: p.grad.cpu() for n, p in model.p.items()}
    return float(loss.detach()), grads, time.perf_counter() - t


def compare_train_step_with_cpu(torch, flash=False, unfused_card=None,
                                amp=False, f32_card=None):
    """Phases 6, 9 and 14: one full-width training forward and backward on
    the card and on the CPU, same weights and batch; with ``unfused_card``
    (the card's result of phase 6) also flash against unfused on the card.
    With ``amp`` (phase 14, flash on) the model is bf16-marked, the limits
    are bf16's (loss within 5e-3 relative, every gradient within 2e-2 of
    its largest magnitude: the same roundings on both sides, float32 sums
    in another order, so an element near a bf16 rounding boundary may land
    a step away and move what follows), and the card's AMP step is set
    beside ``f32_card`` (phase 9's card result) with no limit. Returns the
    card's (loss, gradients, seconds)."""
    from paddle_tpu_torch.models.transformer import LMConfig, init_params
    phase = 'amp_train_vs_cpu' if amp else \
        'flash_train_vs_cpu' if flash else 'train_vs_cpu'
    cfg = LMConfig(dropout=0.0, use_flash_attention=flash)
    params = init_params(cfg, 1, 'cpu')
    g = torch.Generator(device='cpu').manual_seed(5)
    tok = torch.randint(0, cfg.vocab_size, (2, cfg.seq_len), generator=g)
    lab = torch.randint(0, cfg.vocab_size, (2, cfg.seq_len), generator=g)
    card = train_step_grads(torch, cfg, params, tok, lab,
                            torch.device('cuda', 0), amp)
    cpu = train_step_grads(torch, cfg, params, tok, lab, torch.device('cpu'),
                           amp)
    summary = dict(phase=phase, batch=2, seq_len=cfg.seq_len, flash=flash,
                   amp=amp, loss_card=card[0], loss_cpu=cpu[0],
                   seconds_card=card[2], seconds_cpu=cpu[2])
    pairs = [('cpu', cpu)] + ([('unfused_card', unfused_card)]
                              if unfused_card is not None else []) + \
        ([('f32_card', f32_card)] if f32_card is not None else [])
    loss_tol = 5e-3 * abs(cpu[0]) if amp else 1e-4
    grad_tol = 2e-2 if amp else 1e-3
    failures = []
    for what, other in pairs:
        loss_err = abs(card[0] - other[0])
        grad_rel = {n: float((card[1][n] - go).abs().max()
                             / go.abs().max().clamp_min(1e-30))
                    for n, go in other[1].items()}
        worst = max(grad_rel, key=grad_rel.get)
        summary['vs_' + what] = dict(
            loss_abs_err=loss_err, grad_rel_err_max=grad_rel[worst],
            grad_rel_err_worst_param=worst,
            grad_rel_err_median=float(np.median(list(grad_rel.values()))))
        if what == 'f32_card':
            continue            # AMP against float32: reported, no limit
        if not (np.isfinite(card[0]) and loss_err <= loss_tol):
            failures.append('card vs %s training loss: %r vs %r'
                            % (what, card[0], other[0]))
        if not grad_rel[worst] <= grad_tol:
            failures.append('card vs %s gradient of %s differs by %g of its '
                            'largest magnitude' % (what, worst,
                                                   grad_rel[worst]))
    emit(summary)
    if failures:
        raise AssertionError('; '.join(failures))
    return card


def run_training(torch, kt, phase, cfg, kernels, note=None, amp=False,
                 batch=TRAIN_B, idle=()):
    """Phases 7, 10 and 15: the flagship training step with ``cfg`` at
    ``batch`` sequences, bf16 AMP with ``amp`` (the model marked by
    rewrite_model_bf16, Adam decorated); the kernels of ``idle`` must not
    launch. Returns (summary, counts)."""
    from paddle_tpu_torch.contrib import mixed_precision
    from paddle_tpu_torch.models.transformer import TransformerLM, init_params
    from paddle_tpu_torch.optimizer import TensorAdam
    dev = torch.device('cuda', 0)
    model = TransformerLM(cfg, init_params(cfg, 2, dev), cfg.seq_len)
    opt = TensorAdam(model.p, 1e-4, fuse=True)
    marked = None
    if amp:
        marked = mixed_precision.rewrite_model_bf16(model)
        opt = mixed_precision.decorate(opt)
    gen = torch.Generator(device=dev).manual_seed(2024)
    g = torch.Generator(device='cpu').manual_seed(6)
    tok = torch.randint(0, cfg.vocab_size, (batch, cfg.seq_len),
                        generator=g).to(dev)
    lab = torch.randint(0, cfg.vocab_size, (batch, cfg.seq_len),
                        generator=g).to(dev)
    summary, counts = timed_training(
        torch, kt, lambda: opt.minimize(model.loss(tok, lab, gen)),
        TRAIN_STEPS, kernels, idle)
    summary = dict(
        phase=phase, batch=batch, seq_len=cfg.seq_len, dropout=cfg.dropout,
        attn_dropout=cfg.attn_dropout, flash=model.flash_in_training(),
        amp=amp, marked_sites=marked,
        tokens_per_s=batch * cfg.seq_len / (summary['step_ms'] / 1e3),
        **summary)
    if note:
        summary['note'] = note
    return summary, counts


def timed_training(torch, kt, step, steps, kernels, idle=()):
    """Run ``step`` (one training step returning its loss) ``steps`` times
    with the launch counts set to 0 just before: the loss finite and fallen
    by the last step, every kernel of ``kernels`` launched and none of
    ``idle``, the step's ms (first step apart), peak memory and a profile
    of one more step."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kt.reset_counts()
    losses = []
    t0 = time.perf_counter()
    for i in range(steps):
        losses.append(step())
        if i == 0:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = kt.launch_counts()
    losses = [float(v) for v in torch.stack(losses).cpu()]
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)):
        raise AssertionError('non-finite training loss: %s' % losses)
    if not losses[-1] < losses[0]:
        raise AssertionError('the loss did not fall in %d steps: %s'
                             % (steps, losses))
    never = [k for k in kernels if counts[k] <= 0]
    if never:
        raise AssertionError('training kernels never launched: %s' % never)
    wrong = [k for k in idle if counts[k] > 0]
    if wrong:
        raise AssertionError('kernels off this path launched: %s' % wrong)
    return dict(steps=steps, losses=losses, loss_fall=losses[0] - losses[-1],
                first_step_ms=(t1 - t0) * 1e3,
                step_ms=(t2 - t1) / (steps - 1) * 1e3, peak_mem_bytes=peak,
                launches=counts,
                step_profile=step_profile(torch, step, steps=1)), counts


def program_step_launches(cfg, amp=False, flash=True, gathers=1, ces=1):
    """The launches one training step of a program makes (`PERF.md` §6's
    launches columns): the ``gathers`` embedding gathers, the 2L + 1 fused
    LayerNorms forward and backward, the three flash kernels a layer
    (``flash``; their bf16 form under ``amp``), the FFN kernel a layer
    (float32 only: the marked FFN stands it down, as the JAX package
    does), the CE forward and backward of each of ``ces`` losses, one
    fused Adam."""
    from paddle_tpu_torch.ops import kernel_tier as kt
    n, ln = cfg.n_layer, 2 * cfg.n_layer + 1
    out = dict(dict.fromkeys(kt.KERNELS, 0), embedding_gather=gathers,
               fused_ln_residual=ln, fused_ln_residual_bwd=ln,
               softmax_ce_fwd=ces, softmax_ce_bwd=ces, fused_adam=1)
    if flash:
        names = AMP_FLASH_KERNELS if amp else FLASH_KERNELS
        if cfg.d_model // cfg.n_head > 256:
            names = WIDE_FLASH_KERNELS
        out.update(dict.fromkeys(names, n))
    if not amp:
        out['fused_ffn'] = n
    return out


def model_flops(cfg, batch):
    """Model flops of one LM training step, bench.py:58-67's formula
    (`_lm_train_flops_per_step`): the forward's products (QKV, the scores
    and context over all L x L pairs, proj, the two FFN products a layer,
    and the LM head) times 3 for the backward."""
    B, L, d, V, dff = (batch, cfg.seq_len, cfg.d_model, cfg.vocab_size,
                       cfg.d_ff)
    per_layer = (2 * B * L * d * 3 * d + 2 * B * L * L * d
                 + 2 * B * L * L * d + 2 * B * L * d * d
                 + 2 * B * L * d * dff * 2)
    return 3 * (cfg.n_layer * per_layer + 2 * B * L * d * V)


def run_counted(kt, steps, per_step, what):
    """Run each of ``steps`` (functions returning a loss), checking that
    each launches exactly ``per_step``; returns the losses as floats."""
    out = []
    for i, step in enumerate(steps):
        before = kt.launch_counts()
        out.append(float(step().reshape(-1)[0]))
        after = kt.launch_counts()
        got = {k: after[k] - before[k] for k in after}
        if got != per_step:
            raise AssertionError('%s step %d launched %s, the path launches '
                                 '%s' % (what, i, got, per_step))
    return out


def hold_to_model(torch, got, ref, scope, ref_params, d, lr):
    """Phases 10b (a), 15b (a) and 16b (c): the program's losses ``got``
    within 1e-4 relative of the model's ``ref`` at every step, and every
    parameter within 1e-3 of its largest magnitude of ``ref_params`` (the
    K slice of each ``*.attn.qkv.b``, whose true gradient is 0, within 10
    x lr). Returns (summary, failures)."""
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(got, ref)]
    param_rel, kbias = {}, 0.0
    for n, want in ref_params.items():
        have = scope.get(n)
        if n.endswith('.attn.qkv.b'):
            kbias = max(kbias, float((have[d:2 * d] - want[d:2 * d])
                                     .abs().max()))
            have = torch.cat([have[:d], have[2 * d:]])
            want = torch.cat([want[:d], want[2 * d:]])
        param_rel[n] = float((have - want).abs().max() /
                             want.abs().max().clamp_min(1e-30))
    worst = max(param_rel, key=param_rel.get)
    summary = dict(losses=got, ref_losses=ref,
                   loss_rel_err_max=max(loss_rel),
                   bitwise_equal_loss_share=float(np.mean(
                       [a == b for a, b in zip(got, ref)])),
                   param_rel_err_max=param_rel[worst],
                   param_rel_err_worst=worst, k_bias_abs_err_max=kbias)
    failures = []
    if not max(loss_rel) <= 1e-4:
        failures.append('program losses %s against the model\'s %s'
                        % (got, ref))
    if not param_rel[worst] <= 1e-3:
        failures.append('parameter %s differs by %g of its largest '
                        'magnitude' % (worst, param_rel[worst]))
    if not kbias <= 10 * lr:
        failures.append('a K bias differs by %g' % kbias)
    return summary, failures


def build_program(fluid, cfg, is_test=False, amp=False, bert=False):
    """(main, startup, logits, loss) of ``build_lm(cfg)``, or with ``bert``
    (main, startup, (mlm, nsp), total) of ``build_bert_pretrain(cfg)``,
    with ``Adam(1e-4, fuse=True).minimize`` unless ``is_test``,
    ``mixed_precision.decorate``d with ``amp`` (the bench's
    ``amp=True``)."""
    from paddle_tpu_torch.contrib import mixed_precision
    from paddle_tpu_torch.models import bert as bert_model
    from paddle_tpu_torch.models import transformer
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        if bert:
            loss, *logits = bert_model.build_bert_pretrain(cfg,
                                                           is_test=is_test)
        else:
            _, _, logits, loss = transformer.build_lm(cfg, is_test=is_test)
        if not is_test:
            opt = fluid.optimizer.Adam(1e-4, fuse=True)
            if amp:
                opt = mixed_precision.decorate(opt)
            opt.minimize(loss)
    return main, startup, logits, loss


def program_scope(torch, fluid, exe, startup, params):
    """Run the startup program into a new scope (its ms beside it) and
    overwrite its parameters by name with copies of ``params``."""
    scope = fluid.Scope()
    torch.cuda.synchronize()
    t = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    startup_ms = (time.perf_counter() - t) * 1e3
    for name, p in params.items():
        have = scope.get(name)
        if have is None or tuple(have.shape) != tuple(p.shape):
            raise AssertionError('the startup program made no %s of shape '
                                 '%s' % (name, tuple(p.shape)))
        scope.set(name, p.to(exe.device, copy=True))
    return scope, startup_ms


def program_step(exe, main, feed, loss, scope):
    """One training step of ``main`` through ``Executor.run``, its loss
    left on the card."""
    return lambda: exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                           return_numpy=False)[0]


def return_ms(torch, steps, rounds=10):
    """For each function of ``steps``: (host ms to return, ms to the end of
    its device work), medians over ``rounds`` rounds that call each in
    turn, every call started on an idle card (the host's noise falls on
    all of them alike)."""
    host = [[] for _ in steps]
    wall = [[] for _ in steps]
    for _ in range(rounds):
        for i, step in enumerate(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            host[i].append((t1 - t0) * 1e3)
            wall[i].append((time.perf_counter() - t0) * 1e3)
    return [(float(np.median(h)), float(np.median(w)))
            for h, w in zip(host, wall)]


def run_program_train(torch, kt, smi, flash_step):
    """Phase 10b (module docstring). ``flash_step`` is phase 10's summary.
    Returns (summary, {path: launch counts})."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models.transformer import (LMConfig,
                                                     TransformerLM,
                                                     init_params)
    from paddle_tpu_torch.optimizer import TensorAdam
    exe = fluid.Executor()
    dev = exe.device
    if dev != torch.device('cuda', 0):
        raise AssertionError('Executor() runs on %s, not cuda:0' % dev)
    lr = 1e-4
    # phase 10's batch and weights
    g = torch.Generator(device='cpu').manual_seed(6)
    lm = LMConfig()
    tok = torch.randint(0, lm.vocab_size, (TRAIN_B, lm.seq_len), generator=g)
    lab = torch.randint(0, lm.vocab_size, (TRAIN_B, lm.seq_len), generator=g)
    feed = {'tokens': tok.numpy(), 'labels': lab.numpy()}
    params = init_params(lm, 2, 'cpu')
    out = dict(phase='program_train', card=smi, batch=TRAIN_B,
               seq_len=lm.seq_len, steps=PROGRAM_STEPS)
    by_path = {}

    # (a) the two paths held to each other: flash on, no dropout
    cfg = LMConfig(dropout=0.0, attn_dropout=0.0)
    model = TransformerLM(cfg, {k: v.to(dev, copy=True)
                                for k, v in params.items()}, cfg.seq_len)
    opt = TensorAdam(model.p, lr, fuse=True)
    tok_d, lab_d = tok.to(dev), lab.to(dev)
    ref = [float(opt.minimize(model.loss(tok_d, lab_d)))
           for _ in range(PROGRAM_STEPS)]
    ref_params = {n: p.detach().clone() for n, p in model.p.items()}
    del model, opt
    torch.cuda.empty_cache()
    main, startup, _, loss = build_program(fluid, cfg)
    scope, startup_ms = program_scope(torch, fluid, exe, startup, params)
    per_step = program_step_launches(cfg)
    kt.reset_counts()
    got = run_counted(kt, [program_step(exe, main, feed, loss, scope)] *
                      PROGRAM_STEPS, per_step, 'program')
    by_path['program_held'] = kt.launch_counts()
    out['held'], failures = hold_to_model(torch, got, ref, scope, ref_params,
                                          cfg.d_model, lr)
    out['held'].update(launches_per_step=per_step, startup_ms=startup_ms)
    if failures:
        emit(out)
        raise AssertionError('; '.join(failures))
    del scope, ref_params
    torch.cuda.empty_cache()

    # (b) the bench's configuration, timed beside phase 10
    cfg = LMConfig(attn_dropout=0.0)
    main, startup, _, loss = build_program(fluid, cfg)
    scope, _ = program_scope(torch, fluid, exe, startup, params)
    feed_d = {'tokens': tok_d, 'labels': lab_d}
    step = program_step(exe, main, feed_d, loss, scope)
    timed, counts = timed_training(torch, kt, step, PROGRAM_STEPS,
                                   FLASH_TRAIN_KERNELS)
    want = {k: PROGRAM_STEPS * v for k, v in per_step.items()}
    if counts != want:
        raise AssertionError('%d program steps launched %s, not %s'
                             % (PROGRAM_STEPS, counts, want))
    by_path['program_train'] = counts
    fetched_ms = host_ms(torch, lambda: exe.run(
        main, feed=feed_d, fetch_list=[loss], scope=scope), 5)
    model = TransformerLM(cfg, {k: v.to(dev, copy=True)
                                for k, v in params.items()}, cfg.seq_len)
    opt = TensorAdam(model.p, lr, fuse=True)
    gen = torch.Generator(device=dev).manual_seed(2024)
    (exe_host, exe_wall), (lm_host, lm_wall) = return_ms(
        torch, [step, lambda: opt.minimize(model.loss(tok_d, lab_d, gen))])
    del model, opt, scope, step
    torch.cuda.empty_cache()
    out['train'] = dict(
        dropout=cfg.dropout, attn_dropout=cfg.attn_dropout,
        tokens_per_s=TRAIN_B * cfg.seq_len / (timed['step_ms'] / 1e3),
        fetched_step_ms=fetched_ms, host_ms=exe_host, host_wall_ms=exe_wall,
        model_host_ms=lm_host, model_host_wall_ms=lm_wall,
        phase10=flash_step, **timed)

    # (f) the same configuration bound (`Executor.bind`: one CUDA graph
    # a step), held to the eager trajectory, beside (b)'s eager figures;
    # (g) the bound dropout masks against run()'s
    bound, by_path['program_train_bound'] = bound_against_eager(
        torch, kt, cfg, params, feed_d, PROGRAM_STEPS, amp=False)
    bound['eager'] = {k: out['train'][k] for k in (
        'step_ms', 'host_ms', 'tokens_per_s', 'peak_mem_bytes')}
    bound['eager']['device_ms'] = out['train']['step_profile'][
        'device_ms_per_step']
    out['bound'] = bound
    out['bound_dropout'] = check_bound_dropout(torch)

    # (c) LMConfig(): the unfused branch with the assign_value mask
    cfg = LMConfig()
    main, startup, _, loss = build_program(fluid, cfg)
    scope, _ = program_scope(torch, fluid, exe, startup, params)
    timed, by_path['program_default'] = timed_training(
        torch, kt, program_step(exe, main, feed_d, loss, scope),
        PROGRAM_DEFAULT_STEPS, TRAIN_KERNELS,
        idle=FLASH_KERNELS)
    out['default'] = dict(dropout=cfg.dropout,
                          attn_dropout=cfg.attn_dropout, **timed)
    del scope
    torch.cuda.empty_cache()

    # (d) the inference program against TransformerLM.logits
    cfg = LMConfig(dropout=0.0, attn_dropout=0.0)
    main, startup, logits, _ = build_program(fluid, cfg, is_test=True)
    scope, _ = program_scope(torch, fluid, exe, startup, params)
    itok = tok[:PROGRAM_INFER_B]
    got, = exe.run(main, feed={'tokens': itok.numpy()},
                   fetch_list=[logits], scope=scope, return_numpy=False)
    model = TransformerLM(cfg, {k: v.to(dev, copy=True)
                                for k, v in params.items()}, cfg.seq_len)
    with torch.no_grad():
        want = model.logits(itok.to(dev))
    infer_err = float((got.reshape(want.shape) - want).abs().max() /
                      want.abs().max())
    out['infer'] = dict(batch=PROGRAM_INFER_B, rel_err=infer_err,
                        shape=list(got.shape))
    del model, scope, got, want
    torch.cuda.empty_cache()
    if not infer_err <= 1e-4:
        emit(out)
        raise AssertionError('inference logits differ by %g of their '
                             'largest magnitude' % infer_err)

    # (e) the README's quick start
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name='x', shape=[13], dtype='float32')
        y = fluid.layers.data(name='y', shape=[1], dtype='float32')
        cost = fluid.layers.square_error_cost(fluid.layers.fc(x, size=1), y)
        avg = fluid.layers.mean(cost)
        fluid.optimizer.SGD(0.01).minimize(avg)
    rs = np.random.RandomState(11)
    X = rs.randn(64, 13).astype('float32')
    Y = (X @ rs.randn(13, 1) + 0.5).astype('float32')
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    qs = [float(exe.run(main, feed={'x': X, 'y': Y}, fetch_list=[avg],
                        scope=scope)[0][0]) for _ in range(QUICK_START_STEPS)]
    out['quick_start'] = dict(losses=qs)
    if not (np.all(np.isfinite(qs)) and qs[-1] < qs[0]):
        emit(out)
        raise AssertionError('the quick start did not train: %s' % qs)
    return out, by_path


# the bound program step (phases 10b (f) and 15b (f)) and the bench's
# rows through run_fused (15b (b), (d), (e), 16b (d))

def bound_against_eager(torch, kt, cfg, params, feed, steps, amp, lr=1e-4):
    """Phases 10b (f) and 15b (f): ``steps`` eager ``Executor.run`` steps of
    ``build_program(cfg, amp=amp)`` and, on a copy of the same starting
    scope (``params`` over a fresh startup) with a fresh build and a fresh
    Executor (so the same seeds and run counters), ``exe.bind`` and
    ``steps - 1`` bound calls: the losses within 1e-4 relative at every
    step and every parameter within 1e-3 of its largest magnitude
    (`hold_to_model`), each bound call launching exactly one step's
    kernels, no capture after ``bind``. Then the bound step timed: wall ms
    a step (host clock over ``steps`` calls, the fetch read only at the
    end, as `timed_training` times the eager step), the replay's device ms
    (CUDA events around replays of the graph), the host ms a call takes to
    return, peak memory (allocated, from ``bind`` on) and the memory the
    caching allocator holds. Returns (summary, counts of the bound
    calls)."""
    import paddle_tpu_torch as fluid
    per_step = program_step_launches(cfg, amp=amp)
    sides = []
    for _ in range(2):
        exe = fluid.Executor()
        main, startup, _, loss = build_program(fluid, cfg, amp=amp)
        scope, _ = program_scope(torch, fluid, exe, startup, params)
        sides.append((exe, main, loss, scope))
    exe, main, loss, scope = sides.pop(0)
    step = program_step(exe, main, feed, loss, scope)
    ref = [float(v) for v in torch.stack([step() for _ in range(steps)])
           .reshape(-1).cpu()]
    ref_params = {p.name: scope.get(p.name) for p in main.all_parameters()}
    exe, main, loss, scope = sides.pop(0)
    del step
    torch.cuda.empty_cache()
    # peak memory from here: the bind step (eager), the capture and the
    # bound calls, beside the eager side's parameters kept for the hold
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    bp = exe.bind(main, feed, fetch_list=[loss], scope=scope)
    bind_s = time.perf_counter() - t
    if bp.captures != 1:
        raise AssertionError('bind captured %d graphs' % bp.captures)
    kt.reset_counts()
    got = [float(bp.first_out[0].reshape(-1)[0])] + run_counted(
        kt, [lambda: bp(feed, return_numpy=False)[0]] * (steps - 1),
        per_step, 'bound program')
    counts = kt.launch_counts()
    summary, failures = hold_to_model(torch, got, ref, scope, ref_params,
                                      cfg.d_model, lr)
    if bp.captures != 1 or bp.replays != steps - 1:
        failures.append('%d captures, %d replays after %d bound calls'
                        % (bp.captures, bp.replays, steps - 1))
    if failures:
        emit(dict(phase='bound_failure', **summary))
        raise AssertionError('; '.join(failures))
    del ref_params
    call = lambda: bp(feed, return_numpy=False)[0]
    t0 = time.perf_counter()
    for i in range(steps):
        last = call()
        if i == 0:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
    float(last.reshape(-1)[0])
    step_ms = (time.perf_counter() - t1) / (steps - 1) * 1e3
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.memory_reserved()
    (host, wall), = return_ms(torch, [call])
    device_ms = replay_ms(torch, bp.graph, 1, 10)
    if bp.captures != 1:
        raise AssertionError('a bound call captured again')
    B, L = feed['tokens'].shape
    summary.update(
        batch=int(B), steps=steps, bind_s=bind_s, step_ms=step_ms,
        first_call_ms=(t1 - t0) * 1e3, device_ms=device_ms,
        host_ms=host, host_wall_ms=wall,
        tokens_per_s=int(B) * int(L) / (step_ms / 1e3),
        peak_mem_bytes=peak, reserved_bytes=reserved,
        launches_per_step=per_step,
        launches_per_replay=bp.launches, replays=bp.replays,
        captures=bp.captures)
    del bp
    torch.cuda.empty_cache()
    return summary, counts


def check_bound_dropout(torch):
    """The dropout check of phase 10b (g): dropout 0.1 on a fed [64, 1024]
    tensor with its mask fetched; four ``run()`` calls of one build and
    ``bind`` plus three bound calls (replays) of another: each bound mask
    equals the eager mask at the same run index bitwise, and two
    consecutive bound calls draw different masks."""
    import paddle_tpu_torch as fluid

    def build():
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = 11
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            x = fluid.layers.data(name='x', shape=[1024], dtype='float32')
            fluid.layers.dropout(x, 0.1,
                                 dropout_implementation='upscale_in_train')
        return main, main.global_block().ops[-1].output('Mask')[0]

    feed = {'x': np.ones((64, 1024), 'float32')}
    main, mask = build()
    exe = fluid.Executor()
    want = [exe.run(main, feed=feed, fetch_list=[mask])[0]
            for _ in range(4)]
    main, mask = build()
    bp = fluid.Executor().bind(main, feed, fetch_list=[mask])
    got = [bp.first_out[0]] + [bp(feed)[0] for _ in range(3)]
    out = dict(equal=[bool(np.array_equal(g, w)) for g, w in zip(got, want)],
               consecutive_differ=not np.array_equal(got[2], got[3]),
               dropped_share=[float(1 - g.mean()) for g in got],
               replays=bp.replays, captures=bp.captures)
    if not (all(out['equal']) and out['consecutive_differ'] and
            bp.replays == 3):
        raise AssertionError('bound dropout masks: %s' % out)
    return out


def fused_timing(torch, kt, exe, main, loss, scope, batches, per_step,
                 steps=FUSED_STEPS, rounds=FUSED_ROUNDS):
    """bench.py:70-120 `_measure_steps` on the port: the K ``batches``
    stacked on the card (or ``batches`` a stacked feed already), one first
    call of ``steps`` steps (its eager first
    step and the capture), then ``rounds`` calls of ``steps`` steps, each
    timed with its own sync (a read of the loss); the best round over its
    steps. The bench's 120 steps a call and 2-3 rounds are cut to
    ``steps`` and ``rounds`` to keep the script's run short. Every replay
    of the timed rounds launches exactly ``per_step`` and nothing is
    captured after the first call. Returns (summary, counts of the timed
    rounds)."""
    if isinstance(batches, dict):
        stacked, k_batches = batches, int(batches['label'].shape[0])
    else:
        stacked = {k: torch.stack([b[k] for b in batches])
                   for k in batches[0]}
        k_batches = len(batches)
    torch.cuda.synchronize()
    t = time.perf_counter()
    first = exe.run_fused(main, stacked, fetch_list=[loss], scope=scope,
                          steps=steps)
    first_s = time.perf_counter() - t
    plan = [e.bound[scope] for _, e in exe._cache.items()
            if scope in e.bound][-1]
    kt.reset_counts()
    best, losses = float('inf'), [float(first[0].reshape(-1)[0])]
    for _ in range(rounds):
        t = time.perf_counter()
        last = exe.run_fused(main, stacked, fetch_list=[loss], scope=scope,
                             return_numpy=False, steps=steps)
        losses.append(float(last[0].reshape(-1)[0]))          # the sync
        best = min(best, time.perf_counter() - t)
    counts = kt.launch_counts()
    want = {k: rounds * steps * v for k, v in per_step.items()}
    if counts != want:
        raise AssertionError('%d fused steps launched %s, not %s'
                             % (rounds * steps, counts, want))
    if not all(np.isfinite(losses)):
        raise AssertionError('non-finite fused loss: %s' % losses)
    if plan.captures != 1:
        raise AssertionError('run_fused captured %d graphs' % plan.captures)
    return dict(k_batches=k_batches, steps_per_call=steps,
                rounds=rounds, first_call_s=first_s,
                step_ms=best / steps * 1e3, losses=losses,
                replays=plan.replays, captures=plan.captures), counts


def bert_batch(torch, cfg, n, seed, to):
    """A BERT pretraining batch of ``n`` sequences on ``to`` whose
    ``input_mask`` keeps key lengths drawn in 32..L."""
    from paddle_tpu_torch.models import bert
    rs = np.random.RandomState(seed)
    feed = bert.make_pretrain_batch(cfg, n, rs)
    for i, keep in enumerate(rs.randint(32, cfg.seq_len + 1, size=n)):
        feed['input_mask'][i, keep:] = 0.0
    return {k: torch.from_numpy(v).to(to) for k, v in feed.items()}


def bert_forward_ms(torch, kt, model, feed):
    """(ms of one inference forward, the launch counts of one, a profile of
    two) at ``feed``'s batch."""
    kt.reset_counts()
    with torch.no_grad():
        model.loss(is_test=True, **feed)
        torch.cuda.synchronize()
        counts = kt.launch_counts()
        t = time.perf_counter()
        for _ in range(5):
            model.loss(is_test=True, **feed)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) / 5 * 1e3
        profile = step_profile(
            torch, lambda: model.loss(is_test=True, **feed), steps=2)
    return ms, counts, profile


def run_bert(torch, kt):
    """Phase 12: BERT-base at full width. Returns (summary, counts of the
    training steps)."""
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.optimizer import TensorAdam
    dev = torch.device('cuda', 0)
    cfg = bert.BertConfig(attn_dropout=0.0)      # dropout 0.1, flash trains
    params = bert.init_params(cfg, 3, 'cpu')
    model = bert.BertPretrain(cfg, {k: v.to(dev) for k, v in params.items()})

    def batch(n, seed, to):
        return bert_batch(torch, cfg, n, seed, to)

    # (i) the inference losses on the card and on the CPU, (ii) flash
    # against unfused on the card, same weights
    cpu = bert.BertPretrain(cfg, params)
    unfused = bert.BertPretrain(
        bert.BertConfig(attn_dropout=0.0, use_flash_attention=False), model.p)
    with torch.no_grad():
        t = time.perf_counter()
        want = [float(v) for v in cpu.loss(is_test=True,
                                           **batch(4, 1, 'cpu'))]
        cpu_s = time.perf_counter() - t
        got = [float(v) for v in model.loss(is_test=True, **batch(4, 1, dev))]
        unf = [float(v) for v in unfused.loss(is_test=True,
                                              **batch(4, 1, dev))]
    del cpu
    total_err = abs(got[0] - want[0])
    flash_rel = max(abs(a - b) / abs(b) for a, b in zip(got, unf))
    if not (all(np.isfinite(got)) and total_err <= 1e-4):
        raise AssertionError('BERT card vs CPU losses: %s vs %s' % (got, want))
    if not flash_rel <= 1e-4:
        raise AssertionError('BERT flash vs unfused losses: %s vs %s'
                             % (got, unf))

    # (iii) the forward at the inference batch
    feed = batch(BERT_INFER_B, 2, dev)
    infer_ms, infer_counts, infer_profile = bert_forward_ms(torch, kt, model,
                                                            feed)
    del feed
    torch.cuda.empty_cache()

    # (iv) training
    opt = TensorAdam(model.p, 1e-4, fuse=True)
    gen = torch.Generator(device=dev).manual_seed(77)
    feed = batch(BERT_TRAIN_B, 3, dev)
    train, counts = timed_training(
        torch, kt, lambda: opt.minimize(model.loss(generator=gen, **feed)[0]),
        BERT_STEPS, FLASH_TRAIN_KERNELS)
    summary = dict(
        phase='bert', layers=cfg.n_layer, d_model=cfg.d_model,
        heads=cfg.n_head, d_ff=cfg.d_ff, vocab=cfg.vocab_size,
        seq_len=cfg.seq_len, max_predictions=cfg.max_predictions,
        parameters=sum(p.numel() for p in model.p.values()),
        tensors=len(model.p),
        input_mask='key lengths drawn in 32..%d (the bench feeds an '
                   'all-ones mask: a zero bias, no key dropped)' % cfg.seq_len,
        losses_card=got, losses_cpu=want, losses_unfused_card=unf,
        total_abs_err_vs_cpu=total_err, flash_vs_unfused_rel_err=flash_rel,
        cpu_forward_s=cpu_s,
        infer=dict(batch=BERT_INFER_B, forward_ms=infer_ms,
                   samples_per_s=BERT_INFER_B / (infer_ms / 1e3),
                   launches=infer_counts, profile=infer_profile),
        train=dict(batch=BERT_TRAIN_B, dropout=cfg.dropout,
                   attn_dropout=cfg.attn_dropout,
                   samples_per_s=BERT_TRAIN_B / (train['step_ms'] / 1e3),
                   **train))
    return summary, counts


def run_bert_amp(torch, kt, f32_infer_ms):
    """Phase 16: BERT-base under bf16 AMP at the bench's B 128: the
    inference forward (beside phase 12's float32 one, ``f32_infer_ms``), 10
    training steps with attention dropout 0 (so that the biased bf16 flash
    kernels train; every kernel of the AMP path launched, the float32 flash
    kernels and the FFN kernel not), and the bench's own configuration
    (attention dropout 0.1: the unfused branch with its two bf16 matmuls),
    timed only. Returns (summary, counts of the training steps)."""
    from paddle_tpu_torch.contrib import mixed_precision
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.optimizer import TensorAdam
    dev = torch.device('cuda', 0)
    out = dict(phase='bert_amp', batch=AMP_BERT_B)
    counts = None
    for attn_dropout in (0.0, 0.1):
        cfg = bert.BertConfig(attn_dropout=attn_dropout)
        model = bert.BertPretrain(cfg, bert.init_params(cfg, 3, dev))
        marked = mixed_precision.rewrite_model_bf16(model)
        feed = bert_batch(torch, cfg, AMP_BERT_B, 3, dev)
        opt = mixed_precision.decorate(TensorAdam(model.p, 1e-4, fuse=True))
        gen = torch.Generator(device=dev).manual_seed(77)
        step = lambda: opt.minimize(model.loss(generator=gen, **feed)[0])
        if attn_dropout:
            # the bench's configuration: timed only
            step()
            torch.cuda.synchronize()
            kt.reset_counts()
            t = time.perf_counter()
            for _ in range(3):
                step()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) / 3 * 1e3
            out['bench_config'] = dict(
                attn_dropout=attn_dropout, flash=model.flash_ok(False),
                marked_sites=marked, step_ms=ms,
                samples_per_s=AMP_BERT_B / (ms / 1e3),
                launches_per_step={k: n / 3 for k, n in
                                   kt.launch_counts().items()})
        else:
            ms, infer_counts, profile = bert_forward_ms(torch, kt, model,
                                                        feed)
            out['infer'] = dict(forward_ms=ms, f32_forward_ms=f32_infer_ms,
                                samples_per_s=AMP_BERT_B / (ms / 1e3),
                                launches=infer_counts, profile=profile)
            train, counts = timed_training(torch, kt, step, BERT_STEPS,
                                           AMP_TRAIN_KERNELS,
                                           AMP_IDLE_KERNELS)
            out['train'] = dict(attn_dropout=attn_dropout, dropout=cfg.dropout,
                                flash=model.flash_ok(False),
                                marked_sites=marked,
                                samples_per_s=AMP_BERT_B /
                                (train['step_ms'] / 1e3), **train)
        del model, opt, feed, step
        torch.cuda.empty_cache()
    return out, counts


def program_timing(torch, kt, step, steps, per_step, kernels, idle=()):
    """`timed_training` of a program's ``step``, whose launches over the
    ``steps`` must be exactly ``steps`` x ``per_step``; the step's device
    ms and all of its CUDA launches (torch.profiler) beside."""
    timed, counts = timed_training(torch, kt, step, steps, kernels, idle)
    want = {k: steps * v for k, v in per_step.items()}
    if counts != want:
        raise AssertionError('%d program steps launched %s, not %s'
                             % (steps, counts, want))
    prof = timed['step_profile']
    timed.update(device_ms=prof['device_ms_per_step'],
                 cuda_launches_per_step=prof['launches_per_step'],
                 launches_per_step=per_step)
    return timed, counts


def run_program_amp(torch, kt, smi, amp_ref):
    """Phase 15b (module docstring). ``amp_ref`` is {batch: phase 15's
    summary at that batch}. Returns (summary, {path: launch counts})."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.contrib import mixed_precision
    from paddle_tpu_torch.models.transformer import (LMConfig,
                                                     TransformerLM,
                                                     init_params)
    from paddle_tpu_torch.optimizer import TensorAdam
    exe = fluid.Executor()
    dev = exe.device
    lr = 1e-4
    lm = LMConfig()
    params = init_params(lm, 2, 'cpu')         # phase 15's weights
    out = dict(phase='program_amp', card=smi, seq_len=lm.seq_len)
    by_path = {}

    def batch(cfg, n, seed=6):
        g = torch.Generator(device='cpu').manual_seed(seed)
        return {k: torch.randint(0, cfg.vocab_size, (n, cfg.seq_len),
                                 generator=g).to(dev)
                for k in ('tokens', 'labels')}

    def model_step(cfg, feed, weights, gen):
        model = TransformerLM(cfg, {k: v.to(dev, copy=True)
                                    for k, v in weights.items()},
                              cfg.seq_len)
        mixed_precision.rewrite_model_bf16(model)
        opt = mixed_precision.decorate(TensorAdam(model.p, lr, fuse=True))
        return model, lambda: opt.minimize(model.loss(
            feed['tokens'], feed['labels'], gen))

    # (a) the program held to the model path: flash, no dropout, B 16
    cfg = LMConfig(dropout=0.0, attn_dropout=0.0)
    feed = batch(cfg, TRAIN_B)
    model, mstep = model_step(cfg, feed, params, None)
    ref = [float(mstep()) for _ in range(PROGRAM_STEPS)]
    ref_params = {n: p.detach().clone() for n, p in model.p.items()}
    del model, mstep
    torch.cuda.empty_cache()
    main, startup, _, loss = build_program(fluid, cfg, amp=True)
    marked = sum(1 for op in main.global_block().ops
                 if op.attr(mixed_precision.AMP_ATTR))
    scope, _ = program_scope(torch, fluid, exe, startup, params)
    per_step = program_step_launches(cfg, amp=True)
    kt.reset_counts()
    got = run_counted(kt, [program_step(exe, main, feed, loss, scope)] *
                      PROGRAM_STEPS, per_step, 'AMP program')
    by_path['program_amp'] = kt.launch_counts()
    out['held'], failures = hold_to_model(torch, got, ref, scope, ref_params,
                                          cfg.d_model, lr)
    out['held'].update(batch=TRAIN_B, marked_ops=marked,
                       launches_per_step=per_step)
    if failures:
        emit(out)
        raise AssertionError('; '.join(failures))
    del scope, ref_params
    torch.cuda.empty_cache()

    # (b), (c) the bench's flagship row (bench.py:1058-1062) at B 64 and
    # at B 16, each beside phase 15's model step at its batch
    cfg = LMConfig(attn_dropout=0.0)
    for key, n in (('train', AMP_TRAIN_B), ('train_b16', TRAIN_B)):
        feed = batch(cfg, n)
        main, startup, _, loss = build_program(fluid, cfg, amp=True)
        scope, _ = program_scope(torch, fluid, exe, startup, params)
        step = program_step(exe, main, feed, loss, scope)
        timed, counts = program_timing(
            torch, kt, step, PROGRAM_STEPS, per_step, AMP_TRAIN_KERNELS,
            AMP_IDLE_KERNELS)
        for k, v in counts.items():
            by_path['program_amp'][k] += v
        model, mstep = model_step(
            cfg, feed, params, torch.Generator(device=dev).manual_seed(2024))
        (host, wall), (m_host, m_wall) = return_ms(torch, [step, mstep])
        del model, mstep
        fused = None
        if key == 'train':
            # the bench's row as the bench runs it: run_fused over batches
            # staged on the card
            fused, by_path['program_amp_fused'] = fused_timing(
                torch, kt, exe, main, loss, scope,
                [batch(cfg, n, seed=40 + i) for i in range(FUSED_K)],
                per_step)
            fused.update(tokens_per_s=n * cfg.seq_len /
                         (fused['step_ms'] / 1e3),
                         eager_step_ms=timed['step_ms'])
        del scope, step
        torch.cuda.empty_cache()
        ref = amp_ref[n]
        out[key] = dict(fused=fused,
            batch=n, dropout=cfg.dropout, attn_dropout=cfg.attn_dropout,
            tokens_per_s=n * cfg.seq_len / (timed['step_ms'] / 1e3),
            model_tflops=model_flops(cfg, n) / (timed['step_ms'] / 1e3) /
            1e12,
            host_ms=host, host_wall_ms=wall, model_host_ms=m_host,
            model_host_wall_ms=m_wall,
            phase15=dict(step_ms=ref['step_ms'],
                         device_ms=ref['step_profile']['device_ms_per_step'],
                         cuda_launches_per_step=ref['step_profile'][
                             'launches_per_step'],
                         tokens_per_s=ref['tokens_per_s'],
                         peak_mem_bytes=ref['peak_mem_bytes']),
            **timed)

    # (f) the B 16 row bound: 20 bound calls held to 20 eager run() steps,
    # timed beside (c)
    cfg = LMConfig(attn_dropout=0.0)
    bound, by_path['program_amp_bound'] = bound_against_eager(
        torch, kt, cfg, params, batch(cfg, TRAIN_B), BOUND_STEPS, amp=True)
    bound['eager'] = {k: out['train_b16'][k] for k in (
        'step_ms', 'device_ms', 'host_ms', 'tokens_per_s',
        'peak_mem_bytes')}
    out['bound'] = bound

    # (d) lm_large at B 32, (e) lm_long_seq8k at B 2 (bench.py:1118-1129),
    # each then through run_fused
    for key, kw, n in (('program_large', LM_LARGE, LM_LARGE_B),
                       ('program_seq8k', SEQ8K, SEQ8K_B)):
        cfg = LMConfig(**kw)
        feed = batch(cfg, n)
        main, startup, _, loss = build_program(fluid, cfg, amp=True)
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        per = program_step_launches(cfg, amp=True)
        timed, by_path[key] = program_timing(
            torch, kt, program_step(exe, main, feed, loss, scope),
            LARGE_STEPS, per, AMP_TRAIN_KERNELS, AMP_IDLE_KERNELS)
        fused, by_path[key + '_fused'] = fused_timing(
            torch, kt, exe, main, loss, scope,
            [batch(cfg, n, seed=40 + i) for i in range(FUSED_K)], per)
        fused.update(tokens_per_s=n * cfg.seq_len / (fused['step_ms'] / 1e3),
                     eager_step_ms=timed['step_ms'])
        out[key] = dict(
            config=kw, batch=n,
            parameters=sum(int(np.prod(p.shape))
                           for p in main.all_parameters()),
            tokens_per_s=n * cfg.seq_len / (timed['step_ms'] / 1e3),
            model_tflops=model_flops(cfg, n) / (timed['step_ms'] / 1e3) /
            1e12, fused=fused, **timed)
        del scope, main, startup
        torch.cuda.empty_cache()
    return out, by_path


def run_program_bert(torch, kt, smi, bert_ref):
    """Phase 16b (module docstring). ``bert_ref`` holds phase 12's B 128
    forward ms and phase 16's AMP summary. Returns (summary, {path: launch
    counts})."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.optimizer import TensorAdam
    exe = fluid.Executor()
    dev = exe.device
    lr = 1e-4
    out = dict(phase='program_bert', card=smi)
    by_path = {}
    cfg = bert.BertConfig(dropout=0.0, attn_dropout=0.0)
    params = bert.init_params(cfg, 3, 'cpu')        # phase 12's weights

    # (a) the inference program against BertPretrain.loss(is_test=True)
    main, startup, (mlm, nsp), total = build_program(fluid, cfg,
                                                     is_test=True, bert=True)
    scope, _ = program_scope(torch, fluid, exe, startup, params)
    feed = bert_batch(torch, cfg, BERT_CHECK_B, 1, dev)
    got = [float(v[0]) for v in exe.run(main, feed=feed,
                                        fetch_list=[total, mlm, nsp],
                                        scope=scope)]
    model = bert.BertPretrain(cfg, {k: v.to(dev, copy=True)
                                    for k, v in params.items()})
    with torch.no_grad():
        want = [float(v) for v in model.loss(is_test=True, **feed)]
    rel = abs(got[0] - want[0]) / abs(want[0])
    out['infer_check'] = dict(batch=BERT_CHECK_B, losses=got,
                              model_losses=want, total_rel_err=rel)
    if not (all(np.isfinite(got)) and rel <= 1e-5):
        emit(out)
        raise AssertionError('BERT inference program %s against the model '
                             '%s' % (got, want))

    # (b) the inference program at B 128, beside phase 12's forward
    feed = bert_batch(torch, cfg, BERT_INFER_B, 2, dev)
    kt.reset_counts()
    exe.run(main, feed=feed, fetch_list=[total], scope=scope,
            return_numpy=False)
    torch.cuda.synchronize()
    launches = kt.launch_counts()
    ms = host_ms(torch, lambda: exe.run(main, feed=feed, fetch_list=[total],
                                        scope=scope, return_numpy=False), 5)
    out['infer'] = dict(batch=BERT_INFER_B, forward_ms=ms,
                        samples_per_s=BERT_INFER_B / (ms / 1e3),
                        model_forward_ms=bert_ref['f32_infer_ms'],
                        launches=launches)
    del scope, feed
    torch.cuda.empty_cache()

    # (c) training at B 32, no dropout, held to BertPretrain + TensorAdam
    feed = bert_batch(torch, cfg, BERT_TRAIN_B, 3, dev)
    opt = TensorAdam(model.p, lr, fuse=True)
    ref = [float(opt.minimize(model.loss(**feed)[0]))
           for _ in range(BERT_STEPS)]
    ref_params = {n: p.detach().clone() for n, p in model.p.items()}
    del model, opt
    torch.cuda.empty_cache()
    main, startup, _, total = build_program(fluid, cfg, bert=True)
    scope, _ = program_scope(torch, fluid, exe, startup, params)
    per_step = program_step_launches(cfg, gathers=2, ces=2)
    kt.reset_counts()
    got = run_counted(kt, [program_step(exe, main, feed, total, scope)] *
                      BERT_STEPS, per_step, 'BERT program')
    by_path['program_bert'] = kt.launch_counts()
    out['train'], failures = hold_to_model(torch, got, ref, scope,
                                           ref_params, cfg.d_model, lr)
    out['train'].update(batch=BERT_TRAIN_B, launches_per_step=per_step)
    if failures:
        emit(out)
        raise AssertionError('; '.join(failures))
    del scope, ref_params, feed
    torch.cuda.empty_cache()

    # (d) AMP at B 128: the bench's configuration (attention dropout 0.1,
    # the unfused branch) and attention dropout 0 (the biased bf16 flash
    # kernels), each beside phase 16's model step
    by_path['program_bert_amp'] = dict.fromkeys(kt.KERNELS, 0)
    for key, attn_dropout in (('amp_bench_config', 0.1), ('amp_flash', 0.0)):
        cfg = bert.BertConfig(attn_dropout=attn_dropout)
        main, startup, _, total = build_program(fluid, cfg, amp=True,
                                                bert=True)
        scope, _ = program_scope(torch, fluid, exe, startup, params)
        feed = bert_batch(torch, cfg, AMP_BERT_B, 3, dev)
        flash = not attn_dropout
        per = program_step_launches(cfg, amp=True, flash=flash, gathers=2,
                                    ces=2)
        timed, counts = program_timing(
            torch, kt, program_step(exe, main, feed, total, scope),
            BERT_STEPS, per,
            AMP_TRAIN_KERNELS if flash else AMP_BERT_UNFUSED_KERNELS,
            AMP_IDLE_KERNELS + (() if flash else AMP_FLASH_KERNELS))
        for k, v in counts.items():
            by_path['program_bert_amp'][k] += v
        fused = None
        if attn_dropout:
            # the bench's row as the bench runs it (bench.py:279-304)
            fused, by_path['program_bert_fused'] = fused_timing(
                torch, kt, exe, main, total, scope,
                [bert_batch(torch, cfg, AMP_BERT_B, 40 + i, dev)
                 for i in range(FUSED_K)], per)
            fused.update(samples_per_s=AMP_BERT_B / (fused['step_ms'] / 1e3),
                         eager_step_ms=timed['step_ms'])
        ref = bert_ref['amp'][key]
        out[key] = dict(batch=AMP_BERT_B, attn_dropout=attn_dropout,
                        dropout=cfg.dropout, flash=flash,
                        samples_per_s=AMP_BERT_B / (timed['step_ms'] / 1e3),
                        phase16=ref, fused=fused, **timed)
        del scope, feed, main, startup
        torch.cuda.empty_cache()
    return out, by_path

# ---------------------------------------------------------------------------
# phase 17: the bench's inference benchmark through the deploy path


def infer_launches(program):
    """The hand-written launches one call of the pruned inference
    ``program`` makes, predicted from its op list: a gather a
    ``lookup_table``, an LN forward a ``fused_ln_residual``, a flash
    forward a ``flash_attention`` (bf16 under an AMP mark), an FFN a
    ``fused_ffn_tail`` without a mark, a CE forward a
    ``softmax_with_cross_entropy`` with hard labels. Convolution, pooling
    and batch norm launch none: they are library calls, as the JAX package
    has no Pallas kernel there."""
    from paddle_tpu_torch.core import amp
    from paddle_tpu_torch.ops import kernel_tier as kt
    out = dict.fromkeys(kt.KERNELS, 0)
    for op in program.global_block().ops:
        marked = bool(op.attr(amp.AMP_ATTR))
        if op.type == 'lookup_table':
            out['embedding_gather'] += 1
        elif op.type == 'fused_ln_residual':
            out['fused_ln_residual'] += 1
        elif op.type == 'flash_attention':
            out['flash_attention_bf16' if marked else 'flash_attention'] += 1
        elif op.type == 'fused_ffn_tail' and not marked:
            out['fused_ffn'] += 1
        elif op.type == 'softmax_with_cross_entropy' and \
                not op.attr('soft_label', False):
            out['softmax_ce_fwd'] += 1
    return out


def machine_window(torch, kt, pred, feed, per_call):
    """bench.py:566 `_machine_window` on the port: ``run_fused`` of the
    predictor's own program for k1 and for k2 steps over k1 batches staged
    on the card (a float feed above 1 MB drawn there from a seeded
    generator, as the bench draws it; the others stacked from ``feed``),
    each after one untimed call, best of 3 timed calls; ``machine_ms`` is
    the slope (t(k2) - t(k1)) / (k2 - k1), measured once more if the pair
    is not increasing, else None with the windows kept. Then one call of
    k1 steps must launch k1 x ``per_call`` and the bound plan must have
    captured once."""
    import paddle_tpu_torch as fluid
    k1, k2 = INFER_WINDOW
    dev = pred.executor.device
    g = torch.Generator(device=dev).manual_seed(0)
    stacked = {}
    for name, v in feed.items():
        a = np.asarray(v)
        if a.dtype.kind == 'f' and a.nbytes > (1 << 20):
            stacked[name] = torch.randn((k1,) + a.shape, generator=g,
                                        device=dev)
        else:
            stacked[name] = torch.from_numpy(np.stack([a] * k1)).to(dev)

    def fused(steps):
        with fluid.scope_guard(pred.scope):
            return pred.executor.run_fused(pred.program, stacked,
                                           fetch_list=pred.fetch_vars,
                                           steps=steps)

    def timed(steps):
        fused(steps)
        best = float('inf')
        for _ in range(3):
            t = time.perf_counter()
            fused(steps)
            best = min(best, time.perf_counter() - t)
        return best

    t1, t2 = timed(k1), timed(k2)
    if t2 <= t1:
        t1, t2 = timed(k1), timed(k2)
    kt.reset_counts()
    last = fused(k1)
    counts = kt.launch_counts()
    want = {k: k1 * v for k, v in per_call.items()}
    if counts != want:
        raise AssertionError('%d fused inference steps launched %s, not %s'
                             % (k1, counts, want))
    plans = [e.bound[pred.scope] for _, e in pred.executor._cache.items()
             if pred.scope in e.bound]
    if [p.captures for p in plans] != [1]:
        raise AssertionError('the run_fused window captured %s graphs'
                             % [p.captures for p in plans])
    if not all(np.isfinite(np.asarray(o)).all() for o in last):
        raise AssertionError('non-finite fused inference outputs')
    return dict(k=[k1, k2], best_s=[t1, t2],
                machine_ms=(t2 - t1) * 1e3 / (k2 - k1) if t2 > t1 else None,
                replays=plans[0].replays, captures=plans[0].captures)


def infer_row(torch, kt, row, build, make_feed, hold):
    """One row of bench.py:623 `_bench_inference` (module docstring, phase
    17): build, run the startup program, `save_inference_model`,
    `create_predictor` on the card and on the CPU, the checks, then the
    timings. ``hold(card_pred, cpu_pred, feed, out)`` holds the card's B 2
    outputs to the CPU's and returns the card's fetches. Returns (summary,
    the launch counts of one B 128 call)."""
    import tempfile
    import paddle_tpu_torch as fluid
    # what earlier phases still hold: the row's peaks are counted above it
    out = dict(row=row, base_mem_bytes=torch.cuda.memory_allocated())
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 1
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        feeds, targets = build()
    exe, scope = fluid.Executor(), fluid.Scope()
    with tempfile.TemporaryDirectory(prefix='chip_smoke_infer_') as d:
        with fluid.scope_guard(scope):
            exe.run(startup, scope=scope)
            t = time.perf_counter()
            fluid.io.save_inference_model(d, feeds, targets, exe,
                                          main_program=main)
            out['save_s'] = time.perf_counter() - t
        t = time.perf_counter()
        pred = fluid.create_predictor(d)
        out['load_s'] = time.perf_counter() - t
        cpu = fluid.create_predictor(fluid.PredictorConfig(
            d, place=fluid.CPUPlace()))
    per_call = infer_launches(pred.program)
    out['pruned_ops'] = len(pred.program.global_block().ops)
    # (ResNet-50's is empty: its call launches no hand-written kernel)
    out['launches_per_call'] = {k: v for k, v in per_call.items() if v}
    out['hand_written_launches_per_call'] = sum(per_call.values())

    # the B 2 outputs against the CPU predictor on the same artifact, then
    # against Executor.run of the unpruned is_test program on the card
    feed = make_feed(INFER_CHECK_B)
    got = hold(pred, cpu, feed, out)
    held = {n: pred.scope.get(n) for n in pred.scope.names()}
    if not all(isinstance(v, torch.Tensor) and v.is_cuda
               for v in held.values()):
        raise AssertionError('%s: the predictor\'s parameters are not on '
                             'the card after its first call' % row)
    ref = exe.run(main.clone(for_test=True), feed=feed, fetch_list=targets,
                  scope=scope)
    err = max(float(np.abs(g - r).max() / max(np.abs(r).max(), 1e-30))
              for g, r in zip(got, ref))
    out['unpruned'] = dict(bitwise=all(np.array_equal(g, r)
                                       for g, r in zip(got, ref)),
                           rel_err=err)
    if not (out['unpruned']['bitwise'] if row == 'bert_infer'
            else err <= 1e-5):
        emit(out)
        raise AssertionError('%s: the predictor against the unpruned '
                             'is_test program: %s' % (row, out['unpruned']))
    del exe, scope, cpu

    # exact launches a call; the p50 of a call at each batch
    for b in INFER_BATCHES:
        feed = make_feed(b)
        pred.run(feed)
        kt.reset_counts()
        pred.run(feed)
        counts = kt.launch_counts()
        if counts != per_call:
            emit(out)
            raise AssertionError('%s: a B %d call launched %s, the pruned '
                                 'program predicts %s'
                                 % (row, b, counts, per_call))
        if b == INFER_BATCHES[-1]:
            main_counts = counts
        nbytes = sum(np.asarray(v).nbytes for v in feed.values())
        rounds = INFER_ROUNDS_LARGE if nbytes > (8 << 20) else INFER_ROUNDS
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(rounds):
            t = time.perf_counter()
            pred.run(feed)
            times.append((time.perf_counter() - t) * 1e3)
        out['p50_ms_b%d' % b] = sorted(times)[len(times) // 2]
        out['rounds_b%d' % b] = rounds
        out['feed_bytes_b%d' % b] = nbytes
        out['peak_mem_bytes_b%d' % b] = \
            torch.cuda.max_memory_allocated() - out['base_mem_bytes']
    b = INFER_BATCHES[-1]
    out['per_s_b%d' % b] = b / (out['p50_ms_b%d' % b] / 1e3)
    out['step_profile_b%d' % b] = step_profile(torch, lambda: pred.run(feed),
                                               steps=1)
    win = machine_window(torch, kt, pred, feed, per_call)
    out['machine_window_b%d' % b] = win
    out['machine_ms_b%d' % b] = win['machine_ms']
    if win['machine_ms']:
        out['machine_per_s_b%d' % b] = b / (win['machine_ms'] / 1e3)
    if not all(pred.scope.get(n) is v for n, v in held.items()):
        raise AssertionError('%s: a parameter was uploaded again after the '
                             'first call' % row)
    out['params_uploaded_once'] = True
    return out, main_counts


def run_inference(torch, kt, smi):
    """Phase 17 (module docstring). Returns (summaries, {path: the launch
    counts of its B 128 call})."""
    from paddle_tpu_torch.models import bert, resnet
    bcfg = bert.BertConfig(seq_len=128, max_predictions=20)
    by_path = {}

    def bert_build():
        total, _, _ = bert.build_bert_pretrain(bcfg, is_test=True)
        return ['tokens', 'segments', 'input_mask', 'mlm_positions',
                'mlm_labels', 'nsp_labels'], [total]

    rs = np.random.RandomState(0)

    def bert_feed(b):
        return bert.make_pretrain_batch(bcfg, b, rs)

    def bert_hold(pred, cpu, feed, out):
        got, want = pred.run(feed), cpu.run(feed)
        rel = float(abs(got[0][0] - want[0][0]) / abs(want[0][0]))
        out['cpu_check'] = dict(batch=INFER_CHECK_B, loss=float(got[0][0]),
                                cpu_loss=float(want[0][0]), rel_err=rel)
        if not (np.isfinite(got[0]).all() and rel <= 1e-4):
            emit(out)
            raise AssertionError('bert_infer: the card\'s loss %s against '
                                 'the CPU\'s %s' % (got, want))
        return got

    bert_out, by_path['bert_infer'] = infer_row(torch, kt, 'bert_infer',
                                                bert_build, bert_feed,
                                                bert_hold)
    bert_out.update(phase='infer_bert', card=smi, config=dict(
        seq_len=bcfg.seq_len, max_predictions=bcfg.max_predictions,
        d_model=bcfg.d_model, n_layer=bcfg.n_layer, is_test=True))
    emit(bert_out)
    torch.cuda.empty_cache()

    def resnet_build():
        _, _, pred, _, _ = resnet.build('imagenet', depth=50)
        return ['img'], [pred]

    def resnet_feed(b):
        return {'img': rs.randn(b, 3, 224, 224).astype('float32')}

    def resnet_hold(pred, cpu, feed, out):
        got, want = pred.run(feed), cpu.run(feed)
        logits = [op for op in pred.program.global_block().ops
                  if op.type == 'softmax'][-1].input('X')[0]
        g = pred.executor.run(pred.program, feed=feed, fetch_list=[logits],
                              scope=pred.scope)[0]
        w = cpu.executor.run(cpu.program, feed=feed, fetch_list=[logits],
                             scope=cpu.scope)[0]
        err = float(np.abs(g - w).max() / np.abs(w).max())
        out['cpu_check'] = dict(
            batch=INFER_CHECK_B, logits=logits, logits_rel_err=err,
            logits_max_abs=float(np.abs(w).max()),
            probs_abs_err=float(np.abs(got[0] - want[0]).max()),
            tf32_flag=bool(torch.backends.cudnn.allow_tf32))
        if not (np.isfinite(g).all() and err <= 1e-4 and
                out['cpu_check']['probs_abs_err'] <= 1e-4):
            emit(out)
            raise AssertionError('resnet50_infer: the card\'s logits %g of '
                                 'their largest magnitude off the CPU\'s'
                                 % err)
        return got

    # cuDNN's default (TF32 convolutions): the conv lowering keeps float32
    # by itself
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        res_out, by_path['resnet50_infer'] = infer_row(
            torch, kt, 'resnet50_infer', resnet_build, resnet_feed,
            resnet_hold)
        if torch.backends.cudnn.allow_tf32 is not True:
            raise AssertionError('the conv lowering left cuDNN\'s TF32 flag '
                                 'changed')
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    prof = res_out['step_profile_b%d' % INFER_BATCHES[-1]]
    conv_ms = sum(o['ms_per_step'] for o in prof['top_ops']
                  if 'conv' in o['name'])
    res_out.update(phase='infer_resnet50', card=smi,
                   conv_device_share=conv_ms / prof['device_ms_per_step']
                   if prof['device_ms_per_step'] else None,
                   config=dict(variant='imagenet', depth=50,
                               image=[3, 224, 224], classes=1000,
                               is_test=False, cudnn_allow_tf32=True))
    emit(res_out)
    torch.cuda.empty_cache()
    return by_path


# ---------------------------------------------------------------------------
# phase 18: the bench's image training rows through the Fluid front end


def image_batches(shape, classes, k, batch=IMAGE_B):
    """bench.py:227-258's batches of `_bench_image_model`: rng
    ``RandomState(0)``, a teacher projection of the 8 x 8-pooled image (of
    the whole image when a side is not a multiple of 8), then ``k``
    batches of random images, each labelled by the teacher's argmax."""
    rng = np.random.RandomState(0)
    c, h, w = shape
    pool = (h % 8 == 0 and w % 8 == 0)

    def features(imgs):
        if pool:
            imgs = imgs.reshape(imgs.shape[0], c, 8, h // 8, 8, w // 8) \
                .mean(axis=(3, 5))
        return imgs.reshape(imgs.shape[0], -1)

    feat_dim = features(np.zeros((1,) + tuple(shape), 'float32')).shape[1]
    teacher = rng.randn(feat_dim, classes).astype('float32')
    out = []
    for _ in range(k):
        imgs = rng.randn(batch, *shape).astype('float32')
        out.append({'img': imgs, 'label': np.argmax(
            features(imgs) @ teacher, 1).astype('int64').reshape(-1, 1)})
    return out


def image_program(fluid, build, lr, amp=True):
    """(main, startup, loss) of ``build()`` under the bench's optimizer:
    ``decorate(Momentum(lr, 0.9), keep_bf16_activations=True)`` (plain
    Momentum without ``amp``); the startup program seeded."""
    from paddle_tpu_torch.contrib import mixed_precision as mp
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 1
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        _, _, _, loss, _ = build()
        opt = fluid.optimizer.Momentum(learning_rate=lr, momentum=0.9)
        if amp:
            opt = mp.decorate(opt, keep_bf16_activations=True)
        opt.minimize(loss)
    return main, startup, loss


def state_arrays(scope):
    """{name: numpy copy} of every tensor of ``scope`` (a floating one
    float32 but for a float64 tensor: numpy has no bf16; an integer one,
    such as the schedules' step counter, in its own dtype)."""
    import torch
    out = {}
    for n in scope.names():
        v = scope.get(n)
        if hasattr(v, 'detach'):
            v = v.detach()
            if v.is_floating_point() and v.dtype != torch.float64:
                v = v.float()
            out[n] = v.cpu().numpy().copy()
    return out


def hold_steps(got, want, gstate, wstate, groups, loss_limit):
    """One comparison of two runs of a program: the losses ``got`` within
    ``loss_limit`` relative of ``want`` at every step, and each group of
    the state ``groups`` ({label: (names, limit, scale)}) of ``gstate``
    within ``limit`` of ``wstate``'s largest magnitude: each tensor's own
    (``scale`` 'own'), the group's (``scale`` 'set': a batch norm's bias
    starts at 0 and moves by rounding-sized steps), or 1 ('abs'). Returns
    (summary, failures)."""
    loss_rel = max(abs(a / b - 1.0) for a, b in zip(got, want))
    out, failures = dict(losses=got, ref_losses=want,
                         loss_rel_err_max=loss_rel), []
    if not loss_rel <= loss_limit:
        failures.append('losses %s against %s' % (got, want))
    for label, (names, limit, scale) in groups.items():
        diff = {n: float(np.abs(gstate[n] - wstate[n]).max()) for n in names}
        mag = {n: float(np.abs(wstate[n]).max()) for n in names}
        top = max(mag.values(), default=0.0)
        err = {n: diff[n] / max({'own': mag[n], 'set': top, 'abs': 1.0}
                                [scale], 1e-30) for n in names}
        worst = max(err, key=err.get) if err else None
        out[label] = dict(rel_err_max=err.get(worst, 0.0), worst=worst,
                          scale=scale, limit=limit, tensors=len(names))
        if not out[label]['rel_err_max'] <= limit:
            failures.append('%s %s off by %g' % (label, worst, err[worst]))
    return out, failures


def hold_change(init, gstate, wstate, names, norm_limit, diff_limit):
    """The change of the tensors ``names`` from ``init`` over two runs,
    held as one vector: ``gstate``'s change within ``norm_limit``
    relative of ``wstate``'s in norm, and the two changes' difference
    within ``diff_limit`` of ``wstate``'s change's norm (where Adam's
    first, normalised update takes the sign of a gradient within rounding
    of 0, the two may differ by twice the rate in such an element).
    Returns (summary, failures)."""
    def change(st):
        return np.concatenate([(st[n] - init[n]).ravel() for n in names]
                              ).astype(np.float64)
    dg, dw = change(gstate), change(wstate)
    ref = float(np.linalg.norm(dw))
    out = dict(norm=ref, norm_rel_err=abs(float(np.linalg.norm(dg)) /
                                          max(ref, 1e-300) - 1),
               diff_rel=float(np.linalg.norm(dg - dw)) / max(ref, 1e-300),
               norm_limit=norm_limit, diff_limit=diff_limit,
               tensors=len(names))
    failures = []
    if not (ref > 0 and out['norm_rel_err'] <= norm_limit and
            out['diff_rel'] <= diff_limit):
        failures.append('the parameters\' change %s' % out)
    return out, failures


def float64_twin(program):
    """A clone of ``program`` whose float32 variables are float64: the same
    ops and the same lowerings, in float64 (the witness that
    `hold_image_to_cpu` holds both sides to)."""
    twin = program.clone()
    for block in twin.blocks:
        for v in block.vars.values():
            if v.dtype == np.float32:
                v.dtype = np.dtype('float64')
    return twin


def forward_outputs(program):
    """The outputs of ``program``'s forward ops (a batch norm's ``Y``), in
    order, the cast ops of the AMP pass left out."""
    out = []
    for op in program.global_block().ops:
        if op.type == 'backward':
            break
        if op.type in ('conv2d', 'batch_norm', 'elementwise_add',
                       'elementwise_mul', 'pool2d', 'mul', 'softmax'):
            out.append(op.output('Y')[0] if op.type == 'batch_norm'
                       else op.output_arg_names[0])
    return out


def rel_errs(got, want, names):
    """{name: largest |got - want| over the largest |want|} of each
    tensor."""
    return {n: float(np.abs(got[n] - want[n]).max() /
                     max(np.abs(want[n]).max(), 1e-300)) for n in names}


def kind_of(name):
    """The kind of a state tensor: 'velocity', 'stat' (a batch norm's
    moving mean or variance) or 'param' (the rest)."""
    if '_velocity_' in name:
        return 'velocity'
    return 'stat' if name.endswith(('.mean', '.variance')) else 'param'


def rms_dist(got, want, names):
    """{name: the 2-norm of got - want} of each tensor."""
    return {n: float(np.linalg.norm((got[n] - want[n]).ravel()))
            for n in names}


def image_hold_runs(torch, fluid, main, main32, losses, init, feed,
                    steps=2, place=None, fwd=False):
    """The runs `hold_image_to_cpu` compares, each on one batch from
    ``init`` with every dropout at probability 0 (the card's generator and
    the CPU's draw different masks), cuDNN's deterministic algorithms on
    the card: ``steps`` steps of the float64 twin of the float32 program
    (``main32``) on the card and on the CPU, and one step of ``main32`` and
    of the bench's keep-bf16 program ``main`` on each, fetching the losses
    ``losses`` ({'f32': name, 'amp': name}). ``place`` stands for
    the card (None: ``cuda:0``). Returns {(side, kind): dict(losses,
    state (after each step), fwd (with ``fwd``: the first step's forward
    outputs), s (seconds))}, side 'card' or 'cpu', kind 'f64', 'f32' or
    'amp'."""
    from paddle_tpu_torch.io import scope_from_numpy
    progs = {'f64': float64_twin(main32), 'f32': main32.clone(),
             'amp': main.clone()}
    for prog in progs.values():
        for op in prog.global_block().ops:
            if op.type == 'dropout':
                op.attrs['dropout_prob'] = 0.0
    names = forward_outputs(main32) if fwd else []
    runs = {}
    for kind, prog in progs.items():
        cast = (lambda a: a.astype(np.float64) if a.dtype == np.float32
                else a) if kind == 'f64' else (lambda a: a)
        loss = losses['amp' if kind == 'amp' else 'f32']
        for side, pl in (('card', place), ('cpu', fluid.CPUPlace())):
            exe = fluid.Executor(pl)
            scope = scope_from_numpy({n: cast(a) for n, a in init.items()},
                                     device=exe.device)
            run = dict(losses=[], state=[])
            t = time.perf_counter()
            with torch.backends.cudnn.flags(enabled=True,
                                            deterministic=True):
                for i in range(steps if kind == 'f64' else 1):
                    got = exe.run(prog, feed={k: cast(v) for k, v in
                                              feed.items()},
                                  fetch_list=[loss] + (names if i == 0
                                                       else []),
                                  scope=scope)
                    run['losses'].append(float(got[0].reshape(-1)[0]))
                    run['state'].append(state_arrays(scope))
                    if i == 0 and names:
                        run['fwd'] = dict(zip(names, got[1:]))
            run['s'] = time.perf_counter() - t
            runs[side, kind] = run
    return runs


def hold_image_to_cpu(torch, fluid, build, lr, main, loss, init,
                      batch):
    """The row's model on the card held to the CPU Executor on the first
    ``IMAGE_CHECK_B`` images of ``batch`` from the same ``init``
    (`image_hold_runs`), with a float64 witness, since from this random
    initialization the deep nets amplify each rounding of a step far past
    float32's limits (tools/image_witness.py measures it; `PERF.md` §6):

    (a) the float64 twin, two steps: each loss within 1e-9 relative of the
        CPU's, every parameter, velocity and moving statistic after each
        step within 1e-8 of its own largest magnitude: the card computes
        the CPU's function, forward, backward and update;
    (b) the float32 program, one step: the loss within 1e-4 relative of
        the CPU's (`PERF.md` §2), and each gradient (the velocity after
        the step) no further (2-norm of the difference) from the float64
        gradient than ``IMAGE_F32_RATIO`` times the CPU's float32
        gradient, or than ``IMAGE_F32_FLOOR`` of the float64 gradient's
        norm (of the norm it would have at the model's RMS element, where
        that is larger: a bias ahead of a batch norm has a gradient of 0
        but for rounding);
    (c) the bench's keep-bf16 program, one step: the loss within 5e-3
        relative of the float64 loss (`PERF.md` §2's AMP limit) or no
        further from it than ``IMAGE_AMP_RATIO`` times the CPU's, and each
        gradient held as in (b) with ``IMAGE_AMP_RATIO`` and
        ``IMAGE_AMP_FLOOR``.

    Returns the summary; raises on a failure."""
    main32, _, loss32 = image_program(fluid, build, lr, amp=False)
    feed = {k: v[:IMAGE_CHECK_B] for k, v in batch.items()}
    runs = image_hold_runs(torch, fluid, main, main32,
                           {'f32': loss32.name, 'amp': loss.name}, init, feed)
    out, failures = image_hold_verdict(runs, main32)
    if failures:
        emit(dict(phase='image_hold_failure', **out))
        raise AssertionError('the card\'s image programs: %s'
                             % '; '.join(failures))
    return out


def image_hold_verdict(runs, main32):
    """The checks of `hold_image_to_cpu` on ``runs``: (summary,
    failures)."""
    ref = runs['cpu', 'f64']
    state = sorted(ref['state'][0])
    vels = [n for n in state if '_velocity_' in n]
    out, failures = dict(batch=IMAGE_CHECK_B,
                         params=len(main32.all_parameters()),
                         cpu_s={k: r['s'] for (s, k), r in runs.items()
                                if s == 'cpu'}), []
    card = runs['card', 'f64']
    # each tensor against its own largest magnitude, or 1e-3 of the
    # largest of its kind: a bias ahead of a batch norm has a gradient of
    # 0 but for rounding
    top = {}
    for n in state:
        top[kind_of(n)] = max(top.get(kind_of(n), 0.0),
                              float(np.abs(ref['state'][0][n]).max()))
    worst = max((float(np.abs(g[n] - w[n]).max()) / max(
        float(np.abs(w[n]).max()), 1e-3 * top[kind_of(n)], 1e-300), n, i)
        for i, (g, w) in enumerate(zip(card['state'], ref['state']))
        for n in state)
    out['f64'] = dict(loss_rel=[abs(a / b - 1.0) for a, b in
                                zip(card['losses'], ref['losses'])],
                      state_rel_err_max=worst[0], worst_tensor=worst[1],
                      worst_step=worst[2] + 1)
    if not (max(out['f64']['loss_rel']) <= 1e-9 and worst[0] <= 1e-8):
        failures.append('the float64 twin off the CPU\'s')
    exact = ref['state'][0]
    norm = {n: float(np.linalg.norm(exact[n].ravel())) for n in vels}
    # the model's RMS gradient element
    rms = float(np.sqrt(sum(v ** 2 for v in norm.values()) /
                        sum(exact[n].size for n in vels)))
    l64 = ref['losses'][0]
    for kind, ratio, floor in (('f32', IMAGE_F32_RATIO, IMAGE_F32_FLOOR),
                               ('amp', IMAGE_AMP_RATIO, IMAGE_AMP_FLOOR)):
        c, p = runs['card', kind], runs['cpu', kind]
        dc = rms_dist(c['state'][0], exact, vels)
        dp = rms_dist(p['state'][0], exact, vels)
        over = {n: dc[n] / max(ratio * dp[n], floor * max(
            norm[n], rms * np.sqrt(exact[n].size)), 1e-300) for n in vels}
        bad = max(over, key=over.get)
        own = {n: max(norm[n], 1e-300) for n in vels}
        lc, lp = c['losses'][0], p['losses'][0]
        out[kind] = dict(
            loss_card=lc, loss_cpu=lp, loss_f64=l64,
            loss_rel=abs(lc / lp - 1.0),
            grad_rms_err_card_median=float(np.median(
                [dc[n] / own[n] for n in vels])),
            grad_rms_err_cpu_median=float(np.median(
                [dp[n] / own[n] for n in vels])),
            worst_tensor=bad, worst_card=dc[bad] / own[bad],
            worst_cpu=dp[bad] / own[bad], worst_over_limit=over[bad])
        if kind == 'f32':
            loss_ok = out[kind]['loss_rel'] <= 1e-4
        else:
            loss_ok = abs(lc - l64) <= max(ratio * abs(lp - l64),
                                           5e-3 * abs(l64))
        if not loss_ok:
            failures.append('the %s loss off the CPU\'s' % kind)
        if not over[bad] <= 1.0:
            failures.append('the %s gradient of %s off the float64 one'
                            % (kind, bad))
    if not all(np.isfinite(r['losses']).all() for r in runs.values()):
        failures.append('a non-finite loss')
    return out, failures


def fused_stats_equal_runs(torch, fluid, main, loss, init, batches):
    """Batch norm's running statistics through ``run_fused`` against
    ``run()``: from ``init``, K ``run()`` calls on one scope and one
    ``run_fused`` call over the same K batches on another (a fresh bound
    plan: its eager first step with the capture, then K - 1 replays), with
    cuDNN's deterministic algorithms for both, so that the comparison sees
    the bound plan's state handling and not the order of a convolution
    gradient's atomics. Every moving statistic, parameter and velocity
    must be bitwise equal. Returns the summary."""
    from paddle_tpu_torch.io import scope_from_numpy
    with torch.backends.cudnn.flags(enabled=True, deterministic=True):
        # an Executor for each side: each counts its runs from 0, so both
        # draw the same dropout masks
        exe = fluid.Executor()
        ref = scope_from_numpy(init, device=exe.device)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for b in batches:
            exe.run(main, feed=b, fetch_list=[loss], scope=ref,
                    return_numpy=False)
        torch.cuda.synchronize()
        run_ms = (time.perf_counter() - t) * 1e3 / len(batches)
        exe = fluid.Executor()
        fused = scope_from_numpy(init, device=exe.device)
        stacked = {k: torch.stack([b[k] for b in batches])
                   for k in batches[0]}
        exe.run_fused(main, stacked, fetch_list=[loss], scope=fused)
        want, got = state_arrays(ref), state_arrays(fused)
    stats = sorted(n for n in init if n.endswith(('.mean', '.variance')))
    differ = sorted(n for n in want if not np.array_equal(got[n], want[n]))
    moved = sum(not np.array_equal(want[n], init[n]) for n in stats)
    out = dict(k=len(batches), stats=len(stats), stats_moved=moved,
               state=len(want), differ=differ[:8], n_differ=len(differ),
               deterministic_run_ms=run_ms,
               stats_max_abs_err=max(float(np.abs(got[n] - want[n]).max())
                                     for n in stats))
    if differ or moved != len(stats):
        emit(dict(phase='image_stats_failure', **out))
        raise AssertionError('run_fused\'s state off run()\'s: %s' % out)
    return out


def fused_rounds_equal_runs(torch, fluid, main, loss, init, batches,
                            scope, fused):
    """The timed ``run_fused`` rounds (`fused_timing`, on ``scope`` from
    ``init`` through a fresh Executor) against as many ``run()`` calls of
    a fresh Executor from ``init`` over the same cycled ``batches``, both
    under the flags the rounds ran with (cuDNN free to pick a
    nondeterministic backward): the loss that each call returned within
    5e-3 relative of the ``run()`` loss of its last step, and the
    parameters, velocities and moving statistics after the last step
    within 2e-2 of their largest magnitude over the model (`PERF.md` §2's
    AMP limits; a batch norm's bias starts at 0). Returns (summary,
    failures)."""
    from paddle_tpu_torch.io import scope_from_numpy
    steps = fused['steps_per_call']
    n = steps * (1 + fused['rounds'])
    exe = fluid.Executor()
    ref = scope_from_numpy(init, device=exe.device)
    losses = [exe.run(main, feed=batches[i % len(batches)],
                      fetch_list=[loss], scope=ref, return_numpy=False)[0]
              for i in range(n)]
    want = [float(v) for v in torch.cat(losses[steps - 1::steps]).cpu()]
    got, wstate = state_arrays(scope), state_arrays(ref)
    rest = sorted(k for k in wstate if k.endswith(
        ('.mean', '.variance')) or '_velocity_' in k)
    out, failures = hold_steps(
        fused['losses'], want, got, wstate,
        {'params': ([p.name for p in main.all_parameters()], 2e-2, 'set'),
         'stats_and_velocities': (rest, 2e-2, 'set')}, 5e-3)
    out.update(steps=n, bitwise_equal=sum(
        np.array_equal(got[k], wstate[k]) for k in wstate), state=len(wstate))
    return out, failures


def image_row(torch, kt, smi, row, batches):
    """One row of phase 18 (module docstring). Returns (summary, the
    launch counts of its fused rounds)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.io import scope_from_numpy
    name, build, shape, classes, lr, k = row
    torch.cuda.empty_cache()
    out = dict(phase='image_train', row=name, card=smi, batch=IMAGE_B,
               image=list(shape), classes=classes, lr=lr, k_batches=k,
               base_mem_bytes=torch.cuda.memory_allocated())
    t = time.perf_counter()
    main, startup, loss = image_program(fluid, build, lr)
    ops = main.global_block().ops
    out.update(build_s=time.perf_counter() - t, ops=len(ops),
               convs=sum(op.type == 'conv2d' for op in ops),
               params=len(main.all_parameters()))
    exe = fluid.Executor()
    s0 = fluid.Scope()
    exe.run(startup, scope=s0)
    init = state_arrays(s0)
    del s0
    out['param_count'] = int(sum(init[p.name].size
                                 for p in main.all_parameters()))
    held = hold_image_to_cpu(torch, fluid, build, lr, main, loss, init,
                             batches[0])
    emit(dict(phase='image_hold', row=name, card=smi, **held))
    out['cpu_hold'] = dict(
        f64_state_rel_err_max=held['f64']['state_rel_err_max'],
        **{'%s_%s' % (kind, k): held[kind][k] for kind in ('f32', 'amp')
           for k in ('loss_rel', 'worst_over_limit')})
    dev = [{n: torch.from_numpy(v).to(exe.device) for n, v in b.items()}
           for b in batches]
    zero = dict.fromkeys(kt.KERNELS, 0)

    # eager steps through Executor.run: zero hand-written launches
    scope = scope_from_numpy(init, device=exe.device)
    step = lambda i: exe.run(main, feed=dev[i % k], fetch_list=[loss],
                             scope=scope, return_numpy=False)[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kt.reset_counts()
    t0 = time.perf_counter()
    losses = []
    for i in range(IMAGE_EAGER_STEPS):
        losses.append(step(i))
        if i == 0:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if kt.launch_counts() != zero:
        raise AssertionError('%s: an eager step launched %s'
                             % (name, kt.launch_counts()))
    eager = dict(steps=IMAGE_EAGER_STEPS,
                 losses=[float(v) for v in torch.cat(losses).cpu()],
                 first_step_ms=(t1 - t0) * 1e3,
                 step_ms=(t2 - t1) * 1e3 / (IMAGE_EAGER_STEPS - 1),
                 peak_mem_bytes=torch.cuda.max_memory_allocated() -
                 out['base_mem_bytes'])
    eager['images_per_s'] = IMAGE_B / (eager['step_ms'] / 1e3)
    prof = step_profile(torch, lambda: step(0), steps=1, shares=IMAGE_SHARES)
    eager['step_profile'] = prof
    out['eager'] = eager
    del losses
    fused_state = fused_stats_equal_runs(torch, fluid, main, loss, init,
                                         dev)
    out['fused_stats_equal_runs'] = fused_state

    # the bench's run_fused rounds on a fresh scope, through a fresh
    # Executor (whose runs count from 0, as the comparison's do)
    del scope, step
    torch.cuda.empty_cache()
    exe = fluid.Executor()
    scope = scope_from_numpy(init, device=exe.device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused, counts = fused_timing(torch, kt, exe, main, loss, scope, dev,
                                 zero, steps=max(IMAGE_FUSED_STEPS, k),
                                 rounds=IMAGE_FUSED_ROUNDS)
    fused['images_per_s'] = IMAGE_B / (fused['step_ms'] / 1e3)
    fused['peak_mem_bytes'] = torch.cuda.max_memory_allocated() - \
        out['base_mem_bytes']
    out['fused'] = fused
    exe.close()             # the bound plan's graph and pool let go
    torch.cuda.empty_cache()
    out['fused_equal_runs'], failures = fused_rounds_equal_runs(
        torch, fluid, main, loss, init, dev, scope, fused)
    if failures:
        emit(out)
        raise AssertionError('%s: %s' % (name, '; '.join(failures)))
    trail = eager['losses'] + fused['losses']
    if not (all(np.isfinite(trail)) and fused['losses'][-1] <
            eager['losses'][0]):
        emit(out)
        raise AssertionError('%s: the loss did not fall: %s' % (name, trail))
    dms = prof['device_ms_per_step']
    out.update(
        step_ms=fused['step_ms'], images_per_s=fused['images_per_s'],
        peak_mem_bytes=max(eager['peak_mem_bytes'], fused['peak_mem_bytes']),
        busy_share=prof['busy_share'], device_ms=dms,
        conv_share=prof['shares']['conv'] / dms if dms else None,
        elementwise_share=prof['shares']['elementwise'] / dms
        if dms else None,
        hand_written_launches_per_step=0,
        loss_first=eager['losses'][0], loss_last=fused['losses'][-1])
    del scope, dev
    torch.cuda.empty_cache()
    return out, counts


def image_build(name):
    """The builder of the image row ``name`` (`IMAGE_ROWS`)."""
    from paddle_tpu_torch.models import resnet, se_resnext, vgg
    return {'resnet50': lambda: resnet.build('imagenet', depth=50),
            'se_resnext': se_resnext.build,
            'vgg16': lambda: vgg.build(class_dim=10,
                                       image_shape=(3, 32, 32))}[name]


def run_image_training(torch, kt, smi):
    """Phase 18 (module docstring). Returns {path: launch counts}."""
    by_path, cache = {}, {}
    for name, shape, classes, lr, k in IMAGE_ROWS:
        key = (shape, classes, k)
        if key not in cache:
            cache.clear()
            t = time.perf_counter()
            cache[key] = (image_batches(shape, classes, k),
                          time.perf_counter() - t)
        batches, gen_s = cache[key]
        out, by_path[name + '_train'] = image_row(
            torch, kt, smi, (name, image_build(name), shape, classes, lr, k),
            batches)
        out['batches_s'] = gen_s
        emit(out)
    return by_path


def run_optimizer_checks(torch, kt, smi):
    """Phase 18b (module docstring). Returns {path: launch counts}."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.contrib import mixed_precision as mp
    from paddle_tpu_torch.io import scope_from_numpy
    from paddle_tpu_torch.models import resnet
    from paddle_tpu_torch.models.transformer import LMConfig, build_lm
    rs = np.random.RandomState(5)
    cfg = LMConfig(n_layer=2, dropout=0.0, attn_dropout=0.0)

    def decay():
        main, startup = fluid.Program(), fluid.Program()
        startup.random_seed = 2
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            _, _, _, loss, _ = resnet.build('cifar10', depth=8)
            fluid.optimizer.Momentum(
                0.05, 0.9, use_nesterov=True,
                regularization=fluid.regularizer.L2Decay(1e-4)).minimize(loss)
        feeds = [{'img': rs.randn(32, 3, 32, 32).astype('float32'),
                  'label': rs.randint(0, 10, (32, 1)).astype('int64')}] * 3
        return main, startup, loss, feeds, dict.fromkeys(kt.KERNELS, 0)

    def keep_amp():
        main, startup = fluid.Program(), fluid.Program()
        startup.random_seed = 4
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            _, _, _, loss, _ = resnet.build('cifar10', depth=8)
            mp.decorate(fluid.optimizer.Momentum(0.05, 0.9),
                        keep_bf16_activations=True).minimize(loss)
        feeds = [{'img': rs.randn(32, 3, 32, 32).astype('float32'),
                  'label': rs.randint(0, 10, (32, 1)).astype('int64')}] * 3
        return main, startup, loss, feeds, dict.fromkeys(kt.KERNELS, 0)

    def clipped():
        main, startup = fluid.Program(), fluid.Program()
        startup.random_seed = 3
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            _, _, _, loss = build_lm(cfg)
            fluid.clip.set_gradient_clip(
                fluid.clip.GradientClipByGlobalNorm(1.0))
            fluid.optimizer.Adam(1e-3, fuse=True).minimize(loss)
        feeds = [{n: rs.randint(0, cfg.vocab_size, (2, cfg.seq_len))
                  .astype('int64') for n in ('tokens', 'labels')}] * 3
        return main, startup, loss, feeds, program_step_launches(cfg)

    by_path = {}
    for path, make in (('momentum_l2_decay', decay),
                       ('resnet_keep_bf16', keep_amp),
                       ('lm_global_norm_clip', clipped)):
        main, startup, loss, feeds, per_step = make()
        types = [op.type for op in main.global_block().ops]
        exe = fluid.Executor()
        s0 = fluid.Scope()
        exe.run(startup, scope=s0)
        init = state_arrays(s0)
        del s0
        runs = {}
        for side, place in (('card', None), ('cpu', fluid.CPUPlace())):
            e = exe if place is None else fluid.Executor(place)
            scope = scope_from_numpy(init, device=e.device)
            kt.reset_counts()
            with torch.backends.cudnn.flags(enabled=True,
                                            deterministic=True):
                losses = run_counted(
                    kt, [lambda f=f: e.run(main, feed=f, fetch_list=[loss],
                                           scope=scope,
                                           return_numpy=False)[0]
                         for f in feeds],
                    per_step if place is None else
                    dict.fromkeys(kt.KERNELS, 0), path)
            if place is None:
                by_path[path] = kt.launch_counts()
            runs[side] = (losses, state_arrays(scope))
        (got, gstate), (want, wstate) = runs['card'], runs['cpu']
        params = [p.name for p in main.all_parameters()]
        d = cfg.d_model
        for st in (gstate, wstate):
            # the K slice of a qkv bias, whose true gradient is 0, moves
            # by Adam's lr-sized steps of noise: held within 10 x lr
            for n in params:
                if n.endswith('.attn.qkv.b'):
                    st[n + '[K]'] = st[n][d:2 * d]
                    st[n] = np.concatenate([st[n][:d], st[n][2 * d:]])
        # f32 limits, each tensor against its own magnitude; the AMP
        # limits over the model (`PERF.md` §2)
        tol, scale, loss_tol = ((2e-2, 'set', 5e-3)
                                if path == 'resnet_keep_bf16'
                                else (1e-3, 'own', 1e-4))
        held, failures = hold_steps(got, want, gstate, wstate, {
            'params': (params, tol, scale),
            'stats': ([n for n in wstate if n.endswith(
                ('.mean', '.variance'))], tol, scale),
            'k_bias': ([n for n in wstate if n.endswith('[K]')], 1e-2,
                       'abs')}, loss_tol)
        out = dict(phase='optimizer_checks', path=path, card=smi,
                   steps=len(feeds),
                   ops={t: types.count(t) for t in (
                       'momentum', 'scale', 'sum', 'squared_l2_norm',
                       'sqrt', 'elementwise_max', 'elementwise_div',
                       'elementwise_mul', 'fused_adam') if t in types},
                   launches_per_step=per_step, **held)
        emit(out)
        if not got[-1] < got[0]:
            failures.append('the loss did not fall: %s' % got)
        if failures:
            raise AssertionError('%s on the card off the CPU: %s'
                                 % (path, '; '.join(failures)))
    return by_path


# ---------------------------------------------------------------------------
# phase 19: ragged (LoD) sequences: the bench's stacked_lstm row


def stacked_lstm_program(fluid, hid=LSTM_HID, layers=LSTM_LAYERS,
                         vocab=LSTM_VOCAB, emb=LSTM_EMB):
    """bench.py:345-361's program: the word ids' embedding, ``layers`` x
    (fc to 4 x ``hid`` + ``dynamic_lstm``), ``sequence_last_step``, a 2-way
    softmax fc, cross entropy and ``Adam(learning_rate=1e-3)``; the startup
    program seeded. Returns (main, startup, loss)."""
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 1
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        words = fluid.layers.data(name='words', shape=[1], dtype='int64',
                                  lod_level=1)
        label = fluid.layers.data(name='label', shape=[1], dtype='int64')
        h = fluid.layers.embedding(words, size=[vocab, emb])
        for _ in range(layers):
            proj = fluid.layers.fc(h, size=hid * 4)
            h, _ = fluid.layers.dynamic_lstm(input=proj, size=hid * 4)
        last = fluid.layers.sequence_last_step(h)
        pred = fluid.layers.fc(last, size=2, act='softmax')
        loss = fluid.layers.mean(
            fluid.layers.cross_entropy(input=pred, label=label))
        fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, startup, loss


def gru_text_program(fluid, hid=LSTM_HID, vocab=LSTM_VOCAB, emb=LSTM_EMB):
    """A text classifier at the row's widths: the embedding, fc to 3 x
    ``hid`` + ``dynamic_gru``, ``sequence_conv`` (3 rows, ``hid`` filters,
    ReLU), ``sequence_pool(MAX)``, a 2-way softmax fc, cross entropy and
    ``Adam(1e-3)``."""
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 2
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        words = fluid.layers.data(name='words', shape=[1], dtype='int64',
                                  lod_level=1)
        label = fluid.layers.data(name='label', shape=[1], dtype='int64')
        e = fluid.layers.embedding(words, size=[vocab, emb])
        g = fluid.layers.dynamic_gru(fluid.layers.fc(e, size=hid * 3),
                                     size=hid)
        conv = fluid.layers.sequence_conv(g, num_filters=hid, filter_size=3,
                                          act='relu')
        pred = fluid.layers.fc(fluid.layers.sequence_pool(conv, 'max'),
                               size=2, act='softmax')
        loss = fluid.layers.mean(
            fluid.layers.cross_entropy(input=pred, label=label))
        fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, startup, loss


def lstm_batches(rng, tok_score, sl, n, batch=LSTM_B):
    """bench.py:374-383 `make_batches`: ``n`` batches of ``batch``
    sequences of ``sl`` random word ids (one uniform LoD), each labelled
    by the sign of its words' mean score."""
    lod = [list(range(0, (batch + 1) * sl, sl))]
    out = []
    for _ in range(n):
        w = rng.randint(0, LSTM_VOCAB, (batch * sl, 1)).astype('int64')
        sent = tok_score[w.reshape(batch, sl)].mean(1) > 0
        out.append({'words': (w, lod),
                    'label': sent.astype('int64').reshape(-1, 1)})
    return out


def ragged_lstm_batches(rs, n, lens=None, batch=LSTM_CHECK_B):
    """``n`` batches of ``batch`` sequences of one LoD: lengths ``lens``,
    or drawn from 0..128 with the second one empty."""
    if lens is None:
        lens = rs.randint(0, LSTM_BUCKETS[-1] + 1, batch)
        lens[1] = 0
    lod = [[0] + [int(v) for v in np.cumsum(lens)]]
    return [{'words': (rs.randint(0, LSTM_VOCAB, (lod[0][-1], 1))
                       .astype('int64'), lod),
             'label': rs.randint(0, 2, (batch, 1)).astype('int64')}
            for _ in range(n)], [int(v) for v in lens]


def lstm_init(fluid, build):
    """(main, loss, {name: array}) of ``build``'s program, its startup run
    on the card."""
    main, startup, loss = build(fluid)
    exe = fluid.Executor()
    s0 = fluid.Scope()
    exe.run(startup, scope=s0)
    return main, loss, state_arrays(s0)


def lstm_hold(torch, kt, fluid, build, batches, what,
              phase='stacked_lstm_hold'):
    """``build``'s program on the card against the CPU Executor: a
    ``run()`` step on each of ``batches`` from one initialization, the
    losses within 1e-4 relative and every parameter and moment within
    1e-3 of its largest magnitude (`PERF.md` §2's f32 limits); a failure
    prints a ``phase`` line. Returns (summary, {path launch counts of the
    card's steps})."""
    from paddle_tpu_torch.io import scope_from_numpy
    main, loss, init = lstm_init(fluid, build)
    runs, counts = {}, None
    for side, place in (('card', None), ('cpu', fluid.CPUPlace())):
        e = fluid.Executor(place)
        scope = scope_from_numpy(init, device=e.device)
        kt.reset_counts()
        losses = [float(e.run(main, feed=b, fetch_list=[loss],
                              scope=scope)[0][0]) for b in batches]
        if place is None:
            counts = kt.launch_counts()
        runs[side] = (losses, state_arrays(scope))
    (got, gstate), (want, wstate) = runs['card'], runs['cpu']
    held, failures = hold_steps(got, want, gstate, wstate, {
        'params': ([p.name for p in main.all_parameters()], 1e-3, 'own'),
        'moments': ([n for n in wstate if '_moment' in n], 1e-3, 'own')},
        1e-4)
    out = dict(model=what, steps=len(batches), **held)
    if failures:
        emit(dict(phase=phase, **out))
        raise AssertionError('%s on the card off the CPU: %s'
                             % (what, '; '.join(failures)))
    return out, counts


def lstm_mixed_fused(torch, fluid, batches):
    """``run_fused`` over ``batches`` (runs of consecutive batches of two
    LoDs) on the card against as many ``run()`` calls from the same
    initialization: the last loss within 1e-4 relative, the state within
    1e-3 of each tensor's largest magnitude, one bound plan a LoD each
    captured once; whether the two are bitwise equal is reported."""
    from paddle_tpu_torch.io import scope_from_numpy
    main, loss, init = lstm_init(fluid, stacked_lstm_program)
    ref_exe, exe = fluid.Executor(), fluid.Executor()
    ref = scope_from_numpy(init, device=ref_exe.device)
    want = [float(ref_exe.run(main, feed=b, fetch_list=[loss],
                              scope=ref)[0][0]) for b in batches]
    scope = scope_from_numpy(init, device=exe.device)
    got = float(exe.run_fused(main, batches, fetch_list=[loss],
                              scope=scope)[0][0])
    plans = [e.bound[scope] for _, e in exe._cache.items()
             if scope in e.bound]
    gstate, wstate = state_arrays(scope), state_arrays(ref)
    held, failures = hold_steps([got], want[-1:], gstate, wstate, {
        'state': (sorted(wstate), 1e-3, 'own')}, 1e-4)
    lods = [len(b['words'][1][0]) - 1 for b in batches]
    out = dict(phase='stacked_lstm_fused_mixed', steps=len(batches),
               lods=len(set(tuple(b['words'][1][0]) for b in batches)),
               sequences=lods, plans=len(plans),
               captures=[p.captures for p in plans],
               replays=[p.replays for p in plans],
               bitwise_equal=sum(np.array_equal(gstate[k], wstate[k])
                                 for k in wstate),
               state_tensors=len(wstate), **held)
    if len(plans) != out['lods'] or any(p.captures != 1 for p in plans):
        failures.append('%d bound plans captured %s times for %d LoDs'
                        % (len(plans), out['captures'], out['lods']))
    exe.close()
    ref_exe.close()
    return out, failures


def htod_copies(torch, fn):
    """(host-to-device copies, device kernels, wall ms, device ms) the
    profiler records over one call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    events = prof.key_averages()
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA]
    copies = sum(e.count for e in events if 'HtoD' in e.key)
    kernels = sum(e.count for e in device
                  if 'Memcpy' not in e.key and 'Memset' not in e.key)
    return (copies, kernels, wall_ms,
            sum(e.self_device_time_total for e in device) / 1e3)


def lstm_bucket(torch, kt, exe, main, loss, scope, sl, batches, per_step):
    """One bucket of phase 19 (module docstring): eager ``run()`` steps,
    one profiled eager step, then the bench's ``run_fused`` window on the
    batches staged on the card. Returns (summary, launch counts of its
    eager and fused steps)."""
    dev = [{'words': (torch.from_numpy(b['words'][0]).to(exe.device),
                      b['words'][1]),
            'label': torch.from_numpy(b['label']).to(exe.device)}
           for b in batches]
    out = dict(seq_len=sl, tokens_per_batch=LSTM_B * sl)
    step = lambda i: exe.run(main, feed=dev[i % len(dev)], fetch_list=[loss],
                             scope=scope, return_numpy=False)[0]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kt.reset_counts()
    t0 = time.perf_counter()
    losses = []
    for i in range(LSTM_EAGER_STEPS):
        losses.append(step(i))
        if i == 0:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = kt.launch_counts()
    want = {k: LSTM_EAGER_STEPS * v for k, v in per_step.items()}
    if counts != want:
        raise AssertionError('stacked_lstm seq %d: %d eager steps launched '
                             '%s, not %s' % (sl, LSTM_EAGER_STEPS, counts,
                                             want))
    eager = dict(steps=LSTM_EAGER_STEPS,
                 losses=[float(v) for v in torch.cat(losses).cpu()],
                 first_step_ms=(t1 - t0) * 1e3,
                 step_ms=(t2 - t1) * 1e3 / (LSTM_EAGER_STEPS - 1),
                 peak_mem_bytes=torch.cuda.max_memory_allocated() - base)
    kt.reset_counts()
    eager['step_profile'] = step_profile(torch, lambda: step(0), steps=1)
    extra = kt.launch_counts()
    counts = {k: counts[k] + extra[k] for k in counts}
    out['eager'] = eager
    lod = batches[0]['words'][1]
    stacked = {'words': (torch.stack([d['words'][0] for d in dev]), lod),
               'label': torch.stack([d['label'] for d in dev])}
    torch.cuda.reset_peak_memory_stats()
    fused, fcounts = fused_timing(torch, kt, exe, main, loss, scope, stacked,
                                  per_step, steps=LSTM_FUSED_STEPS,
                                  rounds=LSTM_FUSED_ROUNDS)
    fused['peak_mem_bytes'] = torch.cuda.max_memory_allocated() - base
    kt.reset_counts()
    copies, kernels, _, _ = htod_copies(torch, lambda: exe.run_fused(
        main, stacked, fetch_list=[loss], scope=scope, return_numpy=False,
        steps=2)[0].cpu())
    fused['htod_copies_in_2_steps'] = copies
    fused['device_kernels_in_2_steps'] = kernels
    if copies:
        raise AssertionError('stacked_lstm seq %d: %d host-to-device copies '
                             'in two fused steps' % (sl, copies))
    extra = kt.launch_counts()
    counts = {k: counts[k] + fcounts[k] + extra[k] for k in counts}
    out['fused'] = fused
    prof = eager['step_profile']
    out.update(
        step_ms=fused['step_ms'], eager_step_ms=eager['step_ms'],
        samples_per_s=LSTM_B / (fused['step_ms'] / 1e3),
        tokens_per_s=LSTM_B * sl / (fused['step_ms'] / 1e3),
        eager_samples_per_s=LSTM_B / (eager['step_ms'] / 1e3),
        launches_per_step=prof['launches_per_step'],
        busy_share=prof['busy_share'], device_ms=prof['device_ms_per_step'],
        peak_mem_bytes=max(eager['peak_mem_bytes'],
                           fused['peak_mem_bytes']),
        loss_first=eager['losses'][0], loss_last=fused['losses'][-1])
    trail = eager['losses'] + fused['losses']
    if not all(np.isfinite(trail)):
        raise AssertionError('stacked_lstm seq %d: a non-finite loss: %s'
                             % (sl, trail))
    return out, counts


def run_stacked_lstm(torch, kt, smi):
    """Phase 19 (module docstring). Returns {path: launch counts}."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.io import scope_from_numpy
    per_step = dict.fromkeys(kt.KERNELS, 0)
    per_step['embedding_gather'] = 1
    by_path = {}
    rs = np.random.RandomState(19)
    # (a) the ragged holds at B 4 against the CPU Executor
    hold_batches, lens = ragged_lstm_batches(rs, LSTM_CHECK_STEPS)
    for what, build in (('stacked_lstm', stacked_lstm_program),
                        ('gru_conv_max_pool', gru_text_program)):
        held, counts = lstm_hold(torch, kt, fluid, build, hold_batches, what)
        emit(dict(phase='stacked_lstm_hold', card=smi, lengths=lens,
                  launches=counts, **held))
        by_path[what + '_hold'] = counts
    # (b) run_fused over two LoDs in runs (A, A, B, A) against run() calls
    other, lens_b = ragged_lstm_batches(rs, 1)
    mixed = [hold_batches[0], hold_batches[1], other[0], hold_batches[2]]
    out, failures = lstm_mixed_fused(torch, fluid, mixed)
    out.update(card=smi, lengths=[lens, lens_b])
    emit(out)
    if failures:
        raise AssertionError('mixed-LoD run_fused off run(): %s'
                             % '; '.join(failures))
    torch.cuda.empty_cache()

    # (c) the bench's row: B 32 at each bucket length, eager and fused
    t = time.perf_counter()
    main, loss, init = lstm_init(fluid, stacked_lstm_program)
    build_s = time.perf_counter() - t
    rng = np.random.RandomState(0)
    tok_score = rng.randn(LSTM_VOCAB).astype('float32')
    exe = fluid.Executor()
    scope = scope_from_numpy(init, device=exe.device)
    row = dict(phase='stacked_lstm', card=smi, batch=LSTM_B,
               buckets=list(LSTM_BUCKETS), vocab=LSTM_VOCAB,
               embedding=LSTM_EMB, hidden=LSTM_HID, layers=LSTM_LAYERS,
               ops=len(main.global_block().ops),
               param_count=int(sum(init[p.name].size
                                   for p in main.all_parameters())),
               build_s=build_s, launches_per_step_hand_written=per_step,
               cut='steps a window 30 -> %d, rounds -> %d'
                   % (LSTM_FUSED_STEPS, LSTM_FUSED_ROUNDS))
    counts = dict.fromkeys(kt.KERNELS, 0)
    buckets, total_s, samples, tokens = {}, 0.0, 0, 0
    for sl in LSTM_BUCKETS:
        batches = lstm_batches(rng, tok_score, sl, LSTM_FUSED_STEPS)
        res, c = lstm_bucket(torch, kt, exe, main, loss, scope, sl, batches,
                             per_step)
        buckets['seq%d' % sl] = res
        counts = {k: counts[k] + c[k] for k in counts}
        total_s += res['step_ms'] / 1e3
        samples += LSTM_B
        tokens += LSTM_B * sl
        emit(dict(phase='stacked_lstm_bucket', card=smi, **res))
        torch.cuda.empty_cache()
    row.update(
        samples_per_s=samples / total_s, tokens_per_s=tokens / total_s,
        step_ms=total_s / len(LSTM_BUCKETS) * 1e3,
        buckets={k: {n: v[n] for n in (
            'step_ms', 'eager_step_ms', 'samples_per_s', 'tokens_per_s',
            'launches_per_step', 'busy_share', 'device_ms',
            'peak_mem_bytes')} for k, v in buckets.items()},
        captures=sum(v['fused']['captures'] for v in buckets.values()),
        loss_first=buckets['seq%d' % LSTM_BUCKETS[0]]['loss_first'],
        loss_last=buckets['seq%d' % LSTM_BUCKETS[-1]]['loss_last'])
    row['loss_fell'] = row['loss_last'] < row['loss_first']
    emit(row)
    by_path['stacked_lstm'] = counts
    exe.close()
    del scope
    torch.cuda.empty_cache()
    return by_path


# ---------------------------------------------------------------------------
# phase 20: sparse embedding gradients: the bench's CTR rows


def ctr_program(fluid, vocab, dim, is_distributed, hidden=CTR_HIDDEN):
    """bench.py:521-535's program: 26 slots' ids, one ``is_sparse``
    embedding, fc ``hidden`` ReLU twice, fc 1 sigmoid, ``mean(log_loss)``
    and ``Adagrad(0.01)``; the startup program seeded. Returns (main,
    startup, loss)."""
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 1
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids = fluid.layers.data(name='ids', shape=[CTR_SLOTS], dtype='int64')
        label = fluid.layers.data(name='label', shape=[1], dtype='float32')
        emb = fluid.layers.embedding(
            input=fluid.layers.reshape(ids, [-1, CTR_SLOTS, 1]),
            size=[vocab, dim], is_sparse=True, is_distributed=is_distributed)
        flat = fluid.layers.reshape(emb, [-1, CTR_SLOTS * dim])
        h = fluid.layers.fc(flat, size=hidden, act='relu')
        h = fluid.layers.fc(h, size=hidden, act='relu')
        p = fluid.layers.fc(h, size=1, act='sigmoid')
        loss = fluid.layers.mean(fluid.layers.log_loss(p, label))
        fluid.optimizer.Adagrad(learning_rate=0.01).minimize(loss)
    return main, startup, loss


def ctr_batches(vocab, n, batch=CTR_B, seed=0):
    """bench.py:545-551: ``n`` distinct batches of ``batch`` x 26 ids, a
    click iff the ids' fixed random scores sum positive."""
    rng = np.random.RandomState(seed)
    id_score = rng.randn(vocab).astype('float32')
    out = []
    for _ in range(n):
        ids = rng.randint(0, vocab, (batch, CTR_SLOTS)).astype('int64')
        out.append({'ids': ids, 'label': (id_score[ids].sum(1) > 0)
                    .astype('float32').reshape(-1, 1)})
    return out


def check_ctr_gather(torch, F):
    """Phase 20's kernel: the gather of 512 x 26 ids from each row's
    table."""
    dev = torch.device('cuda', 0)
    g = torch.Generator(device=dev).manual_seed(2020)
    cases = []
    for name, vocab, dim, _, _ in CTR_ROWS:
        w = torch.randn((vocab, dim), generator=g, device=dev) * 0.02
        case = gather_case(torch, F, w, CTR_B * CTR_SLOTS, g, name)
        case.update(row=name, dim=dim)
        check_bound('embedding_gather', case)
        cases.append(case)
        del w
    out = dict(tolerance=0.0, cases=cases,
               max_abs_err=max(c['max_abs_err'] for c in cases))
    if out['max_abs_err'] > 0:
        raise AssertionError('the gather at the CTR shapes is off its plain '
                             'version by %g' % out['max_abs_err'])
    emit(dict(phase='ctr_kernel', name='embedding_gather', **out))
    return {'embedding_gather': out}


def ctr_fused_equals_runs(torch, fluid, main, loss, init, feeds):
    """``run_fused`` over ``feeds`` (batches on the card) against as many
    ``run()`` calls, each from a copy of ``init``: (summary, failures)."""
    from paddle_tpu_torch.io import scope_from_numpy
    ref_exe, exe = fluid.Executor(), fluid.Executor()
    ref = scope_from_numpy(init, device=ref_exe.device)
    want = [float(ref_exe.run(main, feed=f, fetch_list=[loss],
                              scope=ref)[0][0]) for f in feeds]
    scope = scope_from_numpy(init, device=exe.device)
    got = float(exe.run_fused(main, feeds, fetch_list=[loss],
                              scope=scope)[0][0])
    plans = [e.bound[scope] for _, e in exe._cache.items()
             if scope in e.bound]
    differ = [n for n in init if not torch.equal(scope.get(n), ref.get(n))]
    out = dict(steps=len(feeds), loss=got, ref_loss=want[-1],
               state_tensors=len(init), differ=differ,
               captures=[p.captures for p in plans])
    failures = []
    if got != want[-1] or differ:
        failures.append('run_fused off run(): loss %r against %r, %s differ'
                        % (got, want[-1], differ))
    if out['captures'] != [1]:
        failures.append('captures %s' % out['captures'])
    exe.close()
    ref_exe.close()
    return out, failures


def ctr_row(torch, kt, fluid, smi, name, vocab, dim, dist, rounds, per_step):
    """One row of phase 20 at its published widths (module docstring).
    Returns (summary, launch counts of its eager and fused steps)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    main, startup, loss = ctr_program(fluid, vocab, dim, dist)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    startup_s = time.perf_counter() - t
    table = [op for op in main.global_block().ops
             if op.type == 'lookup_table'][0].input('W')[0]
    moment = [n for n in scope.names() if n.startswith(table + '_moment')]
    # the table and its moment as they start, on the host (the peak
    # memory on the card is the program's own)
    init = {n: scope.get(n).to('cpu', copy=True) for n in [table] + moment}
    param_count = int(sum(scope.get(p.name).numel()
                          for p in main.all_parameters()))
    batches = ctr_batches(vocab, CTR_WINDOW)
    dev = [{k: torch.from_numpy(v).to(exe.device) for k, v in b.items()}
           for b in batches]
    step = lambda i: exe.run(main, feed=dev[i], fetch_list=[loss],
                             scope=scope, return_numpy=False)[0]
    out = dict(phase=name, card=smi, vocab=vocab, dim=dim, slots=CTR_SLOTS,
               batch=CTR_B, hidden=CTR_HIDDEN, is_distributed=dist,
               optimizer='Adagrad(0.01)', startup_s=startup_s,
               param_count=param_count, ops=len(main.global_block().ops),
               window=CTR_WINDOW, rounds=rounds,
               launches_per_step_hand_written=per_step)
    # (b) eager steps, the untouched rows, one profiled step
    kt.reset_counts()
    t0 = time.perf_counter()
    losses = []
    for i in range(CTR_EAGER_STEPS):
        losses.append(step(i))
        if i == 0:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = kt.launch_counts()
    want = {k: CTR_EAGER_STEPS * v for k, v in per_step.items()}
    if counts != want:
        raise AssertionError('%s: %d eager steps launched %s, not %s'
                             % (name, CTR_EAGER_STEPS, counts, want))
    eager = dict(steps=CTR_EAGER_STEPS,
                 losses=[float(v) for v in torch.cat(losses).cpu()],
                 first_step_ms=(t1 - t0) * 1e3,
                 step_ms=(t2 - t1) * 1e3 / (CTR_EAGER_STEPS - 1),
                 peak_mem_bytes=torch.cuda.max_memory_allocated() - base)
    seen = np.zeros(vocab, bool)
    for b in batches[:CTR_EAGER_STEPS]:
        seen[b['ids'].ravel()] = True
    untouched = torch.from_numpy(~seen)
    lazy = {n: (torch.equal(scope.get(n).cpu()[untouched], v[untouched]),
                not torch.equal(scope.get(n).cpu()[~untouched],
                                v[~untouched]))
            for n, v in init.items()}
    out['untouched_rows'] = dict(rows=int((~seen).sum()),
                                 read_rows=int(seen.sum()),
                                 tensors={n: dict(unchanged=u, moved=m)
                                          for n, (u, m) in lazy.items()})
    if len(moment) != 1 or not all(u and m for u, m in lazy.values()):
        emit(out)
        raise AssertionError('%s: the lazy Adagrad moved an untouched row '
                             'or left a read one: %s' % (name, lazy))
    kt.reset_counts()
    eager['step_profile'] = step_profile(
        torch, lambda: step(CTR_EAGER_STEPS), steps=1)
    extra = kt.launch_counts()
    counts = {k: counts[k] + extra[k] for k in counts}
    out['eager'] = eager
    # (c) run_fused against run() calls from the state the steps left,
    # bitwise
    snap = {n: scope.get(n).clone() for n in scope.names()}
    out['fused_equals_runs'], failures = ctr_fused_equals_runs(
        torch, fluid, main, loss, snap, dev[:CTR_FUSED_K])
    if failures:
        emit(out)
        raise AssertionError('%s: %s' % (name, '; '.join(failures)))
    del snap, init
    torch.cuda.empty_cache()
    # (d) the bench's window on the batches staged on the card
    stacked = {k: torch.stack([d[k] for d in dev]) for k in dev[0]}
    torch.cuda.reset_peak_memory_stats()
    fused, fcounts = fused_timing(torch, kt, exe, main, loss, scope, stacked,
                                  per_step, steps=CTR_WINDOW, rounds=rounds)
    fused['peak_mem_bytes'] = torch.cuda.max_memory_allocated() - base
    kt.reset_counts()
    copies, kernels, _, _ = htod_copies(torch, lambda: exe.run_fused(
        main, stacked, fetch_list=[loss], scope=scope, return_numpy=False,
        steps=2)[0].cpu())
    fused['htod_copies_in_2_steps'] = copies
    fused['device_kernels_in_2_steps'] = kernels
    if copies:
        raise AssertionError('%s: %d host-to-device copies in two fused '
                             'steps' % (name, copies))
    extra = kt.launch_counts()
    counts = {k: counts[k] + fcounts[k] + extra[k] for k in counts}
    out['fused'] = fused
    prof = eager['step_profile']
    out.update(
        step_ms=fused['step_ms'], eager_step_ms=eager['step_ms'],
        samples_per_s=CTR_B / (fused['step_ms'] / 1e3),
        eager_samples_per_s=CTR_B / (eager['step_ms'] / 1e3),
        launches_per_step=prof['launches_per_step'],
        busy_share=prof['busy_share'], device_ms=prof['device_ms_per_step'],
        peak_mem_bytes=max(eager['peak_mem_bytes'], fused['peak_mem_bytes']),
        loss_first=eager['losses'][0], loss_window=fused['losses'][0],
        loss_last=fused['losses'][-1])
    out['loss_fell'] = out['loss_last'] < out['loss_first']
    trail = eager['losses'] + fused['losses']
    if not all(np.isfinite(trail)) or not out['loss_fell']:
        emit(out)
        raise AssertionError('%s: the loss did not fall: %s' % (name, trail))
    exe.close()
    return out, counts


def run_ctr(torch, kt, smi):
    """Phase 20 (module docstring). Returns {path: launch counts}."""
    import paddle_tpu_torch as fluid
    per_step = dict.fromkeys(kt.KERNELS, 0)
    per_step['embedding_gather'] = 1
    by_path = {}
    # (a) the holds at vocabulary 1000 and B 64 against the CPU Executor
    batches = ctr_batches(CTR_HOLD_V, CTR_HOLD_STEPS, batch=CTR_HOLD_B)
    for name, _, dim, dist, _ in CTR_ROWS:
        held, counts = lstm_hold(
            torch, kt, fluid,
            lambda f, d=dim, s=dist: ctr_program(f, CTR_HOLD_V, d, s),
            batches, name, phase='ctr_hold')
        emit(dict(phase='ctr_hold', card=smi, vocab=CTR_HOLD_V, dim=dim,
                  batch=CTR_HOLD_B, is_distributed=dist, launches=counts,
                  **held))
        by_path[name + '_hold'] = counts
    # (b)-(d) each row at its published widths
    for name, vocab, dim, dist, rounds in CTR_ROWS:
        row, by_path[name] = ctr_row(torch, kt, fluid, smi, name, vocab, dim,
                                     dist, rounds, per_step)
        emit(row)
        torch.cuda.empty_cache()
    return by_path


# ---------------------------------------------------------------------------
# phase 22: the flagship LM family at head width 256


def lm_feed(torch, cfg, n, seed, dev):
    """{tokens, labels} [n, L] int64 on ``dev``, drawn on the CPU."""
    g = torch.Generator(device='cpu').manual_seed(seed)
    return {k: torch.randint(0, cfg.vocab_size, (n, cfg.seq_len),
                             generator=g).to(dev)
            for k in ('tokens', 'labels')}


def lm_program_hold(torch, kt, fluid, smi, cfg, amp, path,
                    phase='lm_dh256_hold', build=None):
    """Phase 22's holds (and phase 26's, with its ``build``): ``cfg``'s
    training program (Adam 1e-4, decorated with ``amp``; or what
    ``build(fluid, cfg, amp)`` returns as ``build_program`` does) on the
    card against the CPU Executor from one initialization,
    DH256_HOLD_STEPS ``run()`` steps on one batch of DH256_HOLD_B, each
    card step launching exactly the path's kernels (one fused Adam where
    the program has one): the losses within 1e-4 relative and every
    parameter and moment within 1e-3 of its own largest magnitude
    (float32), or 5e-3 and 2e-2 of its group's (AMP; the parameters, the
    first moments, the second moments); the K slice of each qkv bias,
    whose true gradient is 0, within 10 x 1e-4 (the program's largest
    rate under a schedule); the parameters' change over the steps, the K
    slices aside, within 1e-3 (float32) or 2e-2 (AMP) of the CPU's in
    norm and its difference within 1e-3 or 0.1 of that norm
    (`hold_change`). A step counter (a schedule's) starts at
    EXAMPLE_HOLD_COUNTER0 on both sides and ends equal. Returns (summary,
    launch counts of the card's steps)."""
    from paddle_tpu_torch.io import scope_from_numpy
    main, startup, _, loss = (build or build_program)(fluid, cfg, amp=amp)
    exe = fluid.Executor()
    s0 = fluid.Scope()
    exe.run(startup, scope=s0)
    init = state_arrays(s0)
    del s0
    if COUNTER in init:
        init[COUNTER] = np.full_like(init[COUNTER], EXAMPLE_HOLD_COUNTER0)
    feed = {k: v.cpu().numpy() for k, v in lm_feed(
        torch, cfg, DH256_HOLD_B, 22, 'cpu').items()}
    per_step = dict(program_step_launches(cfg, amp=amp), fused_adam=[
        op.type for op in main.global_block().ops].count('fused_adam'))
    runs, counts = {}, None
    for side, place in (('card', None), ('cpu', fluid.CPUPlace())):
        e = exe if place is None else fluid.Executor(place)
        scope = scope_from_numpy(init, device=e.device)
        kt.reset_counts()
        losses = run_counted(
            kt, [lambda: e.run(main, feed=feed, fetch_list=[loss],
                               scope=scope, return_numpy=False)[0]] *
            DH256_HOLD_STEPS,
            per_step if place is None else dict.fromkeys(kt.KERNELS, 0),
            path)
        if place is None:
            counts = kt.launch_counts()
        runs[side] = (losses, state_arrays(scope))
        del scope
    (got, gstate), (want, wstate) = runs['card'], runs['cpu']
    params = [p.name for p in main.all_parameters()]
    d = cfg.d_model
    for st in (gstate, wstate, init):
        for n in params:
            if n.endswith('.attn.qkv.b'):
                st[n + '[K]'] = st[n][d:2 * d]
                st[n] = np.concatenate([st[n][:d], st[n][2 * d:]])
    tol, scale, loss_tol, diff_tol = (2e-2, 'set', 5e-3, 0.1) if amp else \
        (1e-3, 'own', 1e-4, 1e-3)
    rate = noam_rate(cfg.d_model, EXAMPLE_HOLD_COUNTER0 + DH256_HOLD_STEPS) \
        if COUNTER in init else 1e-4
    held, failures = hold_steps(got, want, gstate, wstate, {
        'params': (params, tol, scale),
        'moments1': ([n for n in wstate if '_moment1_' in n], tol, scale),
        'moments2': ([n for n in wstate if '_moment2_' in n], tol, scale),
        'k_bias': ([n for n in wstate if n.endswith('[K]')], 10 * rate,
                   'abs')}, loss_tol)
    held['change'], more = hold_change(init, gstate, wstate, params, tol,
                                       diff_tol)
    failures += more
    if COUNTER in wstate and not np.array_equal(gstate[COUNTER],
                                                wstate[COUNTER]):
        failures.append('step counter %s against %s' % (gstate[COUNTER],
                                                        wstate[COUNTER]))
    out = dict(phase=phase, path=path, card=smi, amp=amp,
               n_layer=cfg.n_layer, batch=DH256_HOLD_B,
               steps=DH256_HOLD_STEPS, launches_per_step=per_step, **held)
    emit(out)
    if failures:
        raise AssertionError('%s on the card off the CPU: %s'
                             % (path, '; '.join(failures)))
    return out, counts


def lm_dh256_engine(torch, kt, smi):
    """Phase 22 (c): the contiguous engine at ``lm_dh256`` (module
    docstring). Returns (summary, launch counts)."""
    from paddle_tpu_torch.models.transformer import LMConfig, TransformerLM
    from paddle_tpu_torch.serving import GenerateConfig, GenerateEngine
    cfg = GenerateConfig(
        model=LMConfig(**dict(LM_DH256, dropout=0.0)), slots=SLOTS,
        max_len=MAX_LEN, prompt_buckets=list(DH256_BUCKETS),
        max_new_tokens=NEW_TOKENS, seed=0)
    rs = np.random.RandomState(22)
    lens = np.linspace(5, MAX_LEN - 2 * NEW_TOKENS,
                       DH256_REQUESTS).astype(int)
    work = []
    for i, n in enumerate(lens):
        prompt = rs.randint(2, cfg.model.vocab_size, size=int(n))
        work.append((prompt, dict(temperature=0.8, top_k=50, top_p=0.9,
                                  sample_seed=1000 + i) if i % 2 else {}))
    torch.cuda.reset_peak_memory_stats()
    eng = GenerateEngine(cfg)
    warm = eng.warmup()
    check_warm('lm_dh256_engine', warm, 2 + 2 * len(DH256_BUCKETS))
    kt.reset_counts()
    t0 = time.perf_counter()
    with eng:
        reqs = [eng.submit(p, max_new_tokens=NEW_TOKENS, **kw)
                for p, kw in work]
        outs = [r.result(600) for r in reqs]
    wall = time.perf_counter() - t0
    refs = [eng.generate_once(p, max_new_tokens=NEW_TOKENS, **kw)
            for p, kw in work]
    counts = kt.launch_counts()
    stats = eng.stats()
    check_no_late_capture('lm_dh256_engine', stats)
    reasons = [o.finish_reason for o in outs]
    if reasons != ['length'] * len(work) or \
            any(len(o) != NEW_TOKENS for o in outs):
        raise AssertionError('lm_dh256_engine: finish reasons %s' % reasons)
    mismatch = [i for i, (o, r) in enumerate(zip(outs, refs)) if list(o) != r]
    if mismatch:
        raise AssertionError('lm_dh256_engine: concurrent != sequential for '
                             'requests %s' % mismatch)
    idle = [k for k in ENGINE_KERNELS if counts[k] <= 0]
    if idle:
        raise AssertionError('lm_dh256_engine: kernels never launched: %s'
                             % idle)
    # the card's logits against the CPU's, as phase 4 holds them: one
    # 64-token prefill, then one decode step
    dev, model = eng.device, eng.model
    cpu = TransformerLM(cfg.model, {k: v.cpu() for k, v in model.p.items()},
                        MAX_LEN)
    cpu.allocate_cache(SLOTS)
    prompt = rs.randint(2, cfg.model.vocab_size, size=(1, 64))
    _, lg_gpu = model.prefill(torch.from_numpy(prompt).to(dev), 1, 40)
    _, lg_cpu = cpu.prefill(torch.from_numpy(prompt), 1, 40)
    tok, posv = np.zeros(SLOTS, 'int64'), np.zeros(SLOTS, 'int64')
    tok[1], posv[1] = 17, 40
    _, sg_gpu = model.decode_step(torch.from_numpy(tok).to(dev),
                                  torch.from_numpy(posv).to(dev))
    _, sg_cpu = cpu.decode_step(torch.from_numpy(tok), torch.from_numpy(posv))
    lg_gpu, sg_gpu = lg_gpu.cpu(), sg_gpu[1].cpu()
    if not (torch.isfinite(lg_gpu).all() and torch.isfinite(sg_gpu).all()):
        raise AssertionError('lm_dh256_engine: non-finite logits')
    logit_err = max(float((lg_gpu - lg_cpu).abs().max()),
                    float((sg_gpu - sg_cpu[1]).abs().max()))
    if not logit_err <= 1e-3:
        raise AssertionError('lm_dh256_engine: card vs CPU logits differ by '
                             '%g' % logit_err)
    gen = sum(len(o) for o in outs)
    out = dict(phase='lm_dh256_engine', card=smi, requests=len(work),
               prompt_lens=[int(n) for n in lens], new_tokens=gen,
               warmup=warm, wall_s=wall, tokens_per_s=gen / wall,
               concurrent_equals_sequential=True,
               logits_max_abs_err_vs_cpu=logit_err, launches=counts,
               launches_per_replay=replay_launches(eng),
               stats=stats, peak_mem_bytes=torch.cuda.max_memory_allocated())
    del eng, model, cpu
    return out, counts


def run_lm_dh256(torch, kt, smi):
    """Phase 22 (module docstring). Returns {path: launch counts}."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models.transformer import LMConfig
    exe = fluid.Executor()
    dev = exe.device
    by_path = {}
    hold_cfg = LMConfig(**dict(LM_DH256, n_layer=DH256_HOLD_LAYERS,
                               dropout=0.0))
    for amp, key, n, idle in ((True, 'lm_dh256_amp', LM_DH256_B,
                               AMP_IDLE_KERNELS),
                              (False, 'lm_dh256_f32', LM_DH256_F32_B,
                               AMP_FLASH_KERNELS)):
        _, by_path[key + '_hold'] = lm_program_hold(
            torch, kt, fluid, smi, hold_cfg, amp, key + '_hold')
        torch.cuda.empty_cache()
        cfg = LMConfig(**LM_DH256)
        main, startup, _, loss = build_program(fluid, cfg, amp=amp)
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        per = program_step_launches(cfg, amp=amp)
        timed, by_path[key] = program_timing(
            torch, kt, program_step(exe, main, lm_feed(torch, cfg, n, 6, dev),
                                    loss, scope),
            LARGE_STEPS, per, AMP_TRAIN_KERNELS if amp else
            FLASH_TRAIN_KERNELS, idle)
        fused = None
        if amp:
            fused, by_path[key + '_fused'] = fused_timing(
                torch, kt, exe, main, loss, scope,
                [lm_feed(torch, cfg, n, 40 + i, dev) for i in range(FUSED_K)],
                per)
            fused.update(tokens_per_s=n * cfg.seq_len /
                         (fused['step_ms'] / 1e3),
                         eager_step_ms=timed['step_ms'])
        emit(dict(phase='lm_dh256_train', path=key, card=smi, config=LM_DH256,
                  amp=amp, batch=n, head_width=cfg.d_model // cfg.n_head,
                  parameters=sum(int(np.prod(p.shape))
                                 for p in main.all_parameters()),
                  tokens_per_s=n * cfg.seq_len / (timed['step_ms'] / 1e3),
                  model_tflops=model_flops(cfg, n) /
                  (timed['step_ms'] / 1e3) / 1e12, fused=fused, **timed))
        del scope, main, startup
        torch.cuda.empty_cache()
    engine, by_path['lm_dh256_engine'] = lm_dh256_engine(torch, kt, smi)
    emit(engine)
    torch.cuda.empty_cache()
    return by_path


def example_program(fluid, cfg, amp=True, seed=None):
    """(main, startup, lr, loss) of examples/train_lm.py's program for
    ``cfg``, call for call (``build_lm``, ``noam_decay(d_model, 400)``,
    ``mixed_precision.decorate(Adam(learning_rate=lr))``; ``amp`` False
    leaves out the decorate), under a fresh name guard; ``seed`` the
    programs' random seed (the example's are unseeded)."""
    from paddle_tpu_torch.contrib import mixed_precision as mp
    from paddle_tpu_torch.models.transformer import build_lm
    main_p, startup = fluid.Program(), fluid.Program()
    if seed is not None:
        main_p.random_seed = startup.random_seed = seed
    with fluid.program_guard(main_p, startup), fluid.unique_name.guard():
        _, _, _, avg_loss = build_lm(cfg)
        lr = fluid.layers.learning_rate_scheduler.noam_decay(
            cfg.d_model, EXAMPLE_WARMUP)
        opt = fluid.optimizer.Adam(learning_rate=lr)
        (mp.decorate(opt) if amp else opt).minimize(avg_loss)
    return main_p, startup, lr, avg_loss


def noam_rate(d_model, step):
    """noam_decay's rate at ``step`` in float64."""
    return d_model ** -0.5 * min(step ** -0.5, step * EXAMPLE_WARMUP ** -1.5)


def example_batch(stacked, i):
    return {k: v[i % EXAMPLE_K] for k, v in stacked.items()}


def example_fused_equals_runs(torch, fluid, cfg, stacked):
    """Phase 26 (c): ``run_fused`` over EXAMPLE_BITWISE_STEPS batches
    against as many ``run()`` calls, two builds of the program with one
    seed (the dropout masks follow the program's counted stream) from one
    initialization: losses, rates and every state tensor bitwise, the
    counter at the step count on both."""
    from paddle_tpu_torch.io import scope_from_numpy
    exe, n = fluid.Executor(), EXAMPLE_BITWISE_STEPS
    s0 = fluid.Scope()
    exe.run(example_program(fluid, cfg, seed=26)[1], scope=s0)
    init = state_arrays(s0)
    del s0
    runs = []
    for fused in (False, True):
        main, _, lr, loss = example_program(fluid, cfg, seed=26)
        scope = scope_from_numpy(init, device=exe.device)
        feeds = [example_batch(stacked, i) for i in range(n)]
        if fused:
            out = exe.run_fused(main, feeds, fetch_list=[loss, lr],
                                scope=scope, steps=n)
        else:
            for f in feeds:
                out = exe.run(main, feed=f, fetch_list=[loss, lr],
                              scope=scope)
        runs.append(([np.asarray(o) for o in out], state_arrays(scope)))
        del scope, main
        torch.cuda.empty_cache()
    (ro, rs), (fo, fs) = runs
    differ = sorted(k for k in rs if not np.array_equal(rs[k], fs[k]))
    out = dict(steps=n, tensors=len(rs), differ=differ,
               loss_run=float(ro[0].ravel()[0]),
               loss_fused=float(fo[0].ravel()[0]),
               counter_run=int(rs[COUNTER][0]),
               counter_fused=int(fs[COUNTER][0]),
               counter_dtype=str(fs[COUNTER].dtype))
    if differ or sorted(rs) != sorted(fs) or any(
            not np.array_equal(a, b) for a, b in zip(ro, fo)) or \
            out['counter_fused'] != n or out['counter_run'] != n or \
            out['counter_dtype'] != 'int64':
        raise AssertionError('run_fused over %d steps is not %d run() '
                             'calls: %s' % (n, n, out))
    return out


def run_train_lm_example(torch, kt, smi):
    """Phase 26 (module docstring). Returns {path: launch counts}."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.io import scope_from_numpy
    from paddle_tpu_torch.models.transformer import LMConfig
    by_path = {}
    # (a) the program at 2 layers and B 2, dropout 0, against the CPU
    hold_cfg = LMConfig(**dict(EXAMPLE_LM, n_layer=2, dropout=0.0))
    _, by_path['train_lm_example_hold'] = lm_program_hold(
        torch, kt, fluid, smi, hold_cfg, True, 'train_lm_example_hold',
        phase='train_lm_example_hold', build=example_program)
    torch.cuda.empty_cache()

    cfg = LMConfig(**EXAMPLE_LM)
    exe = fluid.Executor()
    dev = exe.device
    main, startup, lr, loss = example_program(fluid, cfg)
    types = [op.type for op in main.global_block().ops]
    per = dict(program_step_launches(cfg, amp=True),
               fused_adam=types.count('fused_adam'))
    rng = np.random.RandomState(0)
    batches = [{
        'tokens': rng.randint(0, cfg.vocab_size,
                              (EXAMPLE_B, cfg.seq_len)).astype('int64'),
        'labels': rng.randint(0, cfg.vocab_size,
                              (EXAMPLE_B, cfg.seq_len)).astype('int64')}
        for _ in range(EXAMPLE_K)]
    stacked = {k: torch.from_numpy(np.stack([b[k] for b in batches])).to(dev)
               for k in batches[0]}
    fetch = [loss, lr]
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    rates, losses = {}, {}

    def read(out, step):
        losses[step] = float(out[0].reshape(-1)[0])
        rates[step] = float(out[1].reshape(-1)[0])

    def eager(on, i, step):
        """An ``Executor.run`` step on scope ``on`` with batch ``i``, read
        as step ``step``."""
        def run():
            out = exe.run(main, feed=example_batch(stacked, i),
                          fetch_list=fetch, scope=on, return_numpy=False)
            read(out, step)
            return out[0]
        return run

    # (b) step 1 on a copy of the initial state (the example's windows
    # report steps 50, 100, 150): its loss and rate, eager
    first = scope_from_numpy(state_arrays(scope), device=dev)
    kt.reset_counts()
    run_counted(kt, [eager(first, 0, 1)], per, 'train_lm_example step 1')
    del first
    torch.cuda.empty_cache()

    # (c) the example's loop: a warm window, then timed windows
    def window(steps=EXAMPLE_WINDOW):
        return exe.run_fused(main, stacked, fetch_list=fetch, scope=scope,
                             steps=steps, return_numpy=False)

    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    read(window(), EXAMPLE_WINDOW)
    first_call_s = time.perf_counter() - t
    plan = [e.bound[scope] for _, e in exe._cache.items()
            if scope in e.bound][-1]
    kt.reset_counts()
    done, window_ms = EXAMPLE_WINDOW, []
    for _ in range(EXAMPLE_TIMED):
        t = time.perf_counter()
        out = window()
        done += EXAMPLE_WINDOW
        read(out, done)                                    # the sync
        window_ms.append((time.perf_counter() - t) * 1e3)
    counts = kt.launch_counts()
    want = {k: EXAMPLE_TIMED * EXAMPLE_WINDOW * v for k, v in per.items()}
    if counts != want:
        raise AssertionError('%d fused example steps launched %s, not %s'
                             % (EXAMPLE_TIMED * EXAMPLE_WINDOW, counts,
                                want))
    by_path['train_lm_example'] = counts
    step_ms = min(window_ms) / EXAMPLE_WINDOW
    # (d) one profiled window: device ms, busy share, launches, copies
    htod, launches, wall_ms, dev_ms = htod_copies(
        torch, lambda: read(window(EXAMPLE_PROFILED),
                            done + EXAMPLE_PROFILED))
    done += EXAMPLE_PROFILED
    # (e) one Executor.run step, timed eagerly (its plan built at step 1)
    t = time.perf_counter()
    run_counted(kt, [eager(scope, done, done + 1)], per,
                'train_lm_example eager step')
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t) * 1e3
    done += 1
    counter = scope.get(COUNTER)
    rate_err = {s: abs(r / noam_rate(cfg.d_model, s) - 1)
                for s, r in rates.items()}
    tokens = EXAMPLE_B * cfg.seq_len
    out = dict(
        phase='train_lm_example', card=smi, config=EXAMPLE_LM,
        batch=EXAMPLE_B, k_batches=EXAMPLE_K, window=EXAMPLE_WINDOW,
        adam_ops=types.count('adam'), fused_adam_ops=types.count(
            'fused_adam'),
        parameters=sum(int(np.prod(p.shape))
                       for p in main.all_parameters()),
        first_call_s=first_call_s, window_ms=window_ms, step_ms=step_ms,
        tokens_per_s=tokens / (step_ms / 1e3),
        model_tflops=model_flops(cfg, EXAMPLE_B) / (step_ms / 1e3) / 1e12,
        profiled_steps=EXAMPLE_PROFILED,
        profiled_wall_ms_per_step=wall_ms / EXAMPLE_PROFILED,
        device_ms_per_step=dev_ms / EXAMPLE_PROFILED,
        busy_share=dev_ms / wall_ms if dev_ms > 0 else None,
        cuda_launches_per_step=launches / EXAMPLE_PROFILED,
        htod_copies_in_replays=htod, eager_step_ms=eager_ms,
        launches_per_step=per, launches=counts,
        replays=plan.replays, captures=plan.captures,
        rates={s: dict(got=r, closed_form=noam_rate(cfg.d_model, s),
                       rel_err=rate_err[s]) for s, r in sorted(rates.items())},
        losses=dict(sorted(losses.items())), steps=done,
        counter=int(counter[0]), counter_dtype=str(counter.dtype),
        peak_mem_bytes=torch.cuda.max_memory_allocated())
    out['loss_fell'] = losses[EXAMPLE_WINDOW * (1 + EXAMPLE_TIMED)] < \
        losses[1]
    del scope, plan
    torch.cuda.empty_cache()
    out['fused_equals_runs'] = example_fused_equals_runs(torch, fluid, cfg,
                                                         stacked)
    emit(out)
    failures = []
    if out['adam_ops'] != len(main.all_parameters()) or \
            out['fused_adam_ops']:
        failures.append('%d adam and %d fused_adam ops for %d parameters'
                        % (out['adam_ops'], out['fused_adam_ops'],
                           len(main.all_parameters())))
    if max(rate_err.values()) > 1e-6:
        failures.append('rates off the closed form: %s' % out['rates'])
    if out['counter'] != done or out['counter_dtype'] != 'torch.int64':
        failures.append('counter %d (%s) after %d steps'
                        % (out['counter'], out['counter_dtype'], done))
    if not all(np.isfinite(list(losses.values()))) or not out['loss_fell']:
        failures.append('losses %s' % out['losses'])
    if htod:
        failures.append('%d host-to-device copies in %d replayed steps'
                        % (htod, EXAMPLE_PROFILED))
    if out['captures'] != 1:
        failures.append('run_fused captured %d graphs' % out['captures'])
    if failures:
        raise AssertionError('train_lm_example: %s' % '; '.join(failures))
    return by_path


# ---------------------------------------------------------------------------
# phase 27: control flow: the bench's machine_translation row


def nmt_config(hold=False, beam_size=GEN_BEAM):
    from paddle_tpu_torch.models.seq2seq import Seq2SeqConfig
    if not hold:
        return Seq2SeqConfig(beam_size=beam_size)
    w = NMT_HOLD_W
    return Seq2SeqConfig(dict_size=NMT_HOLD_V, embedding_dim=w,
                         encoder_size=w, decoder_size=w,
                         beam_size=beam_size)


def nmt_programs(fluid, cfg, max_len):
    """bench.py:441-445's training program (``build_nmt_train`` under
    ``Adam(1e-4)``) and :481-483's generation program
    (``build_nmt_generate``), each with a seeded startup program. Returns
    (main, startup, loss, feed names, gmain, gstartup, (ids, scores))."""
    from paddle_tpu_torch.models.seq2seq import (build_nmt_generate,
                                                 build_nmt_train)
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 27
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        feeds, loss, _ = build_nmt_train(cfg)
        fluid.optimizer.Adam(learning_rate=1e-4).minimize(loss)
    gmain, gstartup = fluid.Program(), fluid.Program()
    gstartup.random_seed = 28
    with fluid.program_guard(gmain, gstartup), fluid.unique_name.guard():
        _, fetch = build_nmt_generate(cfg, max_len=max_len)
    return main, startup, loss, feeds, gmain, gstartup, list(fetch)


def nmt_batches(rng, feeds, vocab, lens, n, to=None):
    """``n`` batches of source, target and label ids of one LoD (the
    lengths ``lens``), each ``(ids [T, 1], lod)``, moved by ``to``."""
    lod = [[0] + [int(v) for v in np.cumsum(lens)]]
    out = []
    for _ in range(n):
        b = {}
        for name in feeds:
            ids = rng.randint(1, vocab, (lod[0][-1], 1)).astype('int64')
            b[name] = (to(ids) if to else ids, lod)
        out.append(b)
    return out


def gen_feed(rng, vocab, batch, beam, seq_len, to=None):
    """bench.py:486-492's generation feed: ``batch`` source sentences of
    ``seq_len`` ids and the decoder's initial beams (start id 0)."""
    from paddle_tpu_torch.contrib.decoder import BeamSearchDecoder
    src = rng.randint(1, vocab, (batch * seq_len, 1)).astype('int64')
    init_ids, init_scores = BeamSearchDecoder.make_initial_beams(batch, beam,
                                                                 0)
    to = to or (lambda a: a)
    return {'source_sequence': (to(src), [list(range(
                0, (batch + 1) * seq_len, seq_len))]),
            'init_ids': to(init_ids), 'init_scores': to(init_scores)}


def check_nmt_gather(torch, F):
    """Phase 27's kernel: the gather from the [30000, 512] tables at the
    row's shapes: the B 32 x L 30 source and target ids, the generation's
    8 x 30 source ids and its 24 beam lanes a step."""
    dev = torch.device('cuda', 0)
    g = torch.Generator(device=dev).manual_seed(2727)
    cfg = nmt_config()
    w = torch.randn((cfg.dict_size, cfg.embedding_dim), generator=g,
                    device=dev) * 0.02
    cases = [gather_case(torch, F, w, n, g, at) for n, at in (
        (NMT_B * NMT_L, 'nmt_train'), (GEN_B * NMT_L, 'nmt_generate'),
        (GEN_B * GEN_BEAM, 'nmt_generate_step'))]
    for c in cases:
        check_bound('embedding_gather', c)
    out = dict(tolerance=0.0, cases=cases,
               max_abs_err=max(c['max_abs_err'] for c in cases))
    if out['max_abs_err'] > 0:
        raise AssertionError('the gather at the NMT shapes is off its plain '
                             'version by %g' % out['max_abs_err'])
    emit(dict(phase='nmt_kernel', name='embedding_gather', **out))
    return {'embedding_gather': out}


def nmt_hold(torch, kt, fluid, smi):
    """Phase 27 (a): the training program at the hold size on the card
    against the CPU Executor (three ``run()`` steps on ragged B 4 batches
    from one initialization) at the f32 limits, the parameters' change
    over the steps held as one vector (`hold_change`, 1e-3 and 1e-3), and
    the generation program through ``run()`` on both: the beam ids equal,
    the scores within 1e-4 relative. Returns the card's launch counts."""
    from paddle_tpu_torch.io import scope_from_numpy
    cfg = nmt_config(hold=True)
    main, startup, loss, feeds, gmain, gstartup, gfetch = nmt_programs(
        fluid, cfg, NMT_HOLD_MAX_LEN)
    rng = np.random.RandomState(270)
    batches = nmt_batches(rng, feeds, NMT_HOLD_V, NMT_HOLD_LENS,
                          NMT_HOLD_STEPS)
    gfeed = gen_feed(rng, NMT_HOLD_V, len(NMT_HOLD_LENS), GEN_BEAM, 6)
    s0, g0 = fluid.Scope(), fluid.Scope()
    fluid.Executor().run(startup, scope=s0)
    fluid.Executor().run(gstartup, scope=g0)
    init, ginit = state_arrays(s0), state_arrays(g0)
    runs, counts = {}, None
    for side, place in (('card', None), ('cpu', fluid.CPUPlace())):
        e = fluid.Executor(place)
        scope = scope_from_numpy(init, device=e.device)
        kt.reset_counts()
        losses = [float(e.run(main, feed=b, fetch_list=[loss],
                              scope=scope)[0][0]) for b in batches]
        gen = e.run(gmain, feed=gfeed, fetch_list=gfetch,
                    scope=scope_from_numpy(ginit, device=e.device))
        if place is None:
            counts = kt.launch_counts()
        runs[side] = (losses, state_arrays(scope), gen)
    (got, gstate, ggen), (want, wstate, wgen) = runs['card'], runs['cpu']
    params = [p.name for p in main.all_parameters()]
    held, failures = hold_steps(got, want, gstate, wstate, {
        'params': (params, 1e-3, 'own'),
        'moments': ([n for n in wstate if '_moment' in n], 1e-3, 'own')},
        1e-4)
    held['change'], more = hold_change(init, gstate, wstate, params, 1e-3,
                                       1e-3)
    failures += more
    ids_equal = bool(np.array_equal(ggen[0], wgen[0]))
    score_rel = float(np.max(np.abs(ggen[1] - wgen[1]) /
                             np.maximum(np.abs(wgen[1]), 1e-30)))
    out = dict(phase='nmt_hold', card=smi, lengths=list(NMT_HOLD_LENS),
               vocab=NMT_HOLD_V, width=NMT_HOLD_W, launches=counts,
               beam_ids_equal=ids_equal, beam_shape=list(ggen[0].shape),
               beam_score_rel_err_max=score_rel, **held)
    if not ids_equal:
        first = [int(v) for v in np.argwhere(ggen[0] != wgen[0])[0]]
        out['first_difference'] = dict(
            at=first, card=int(ggen[0][tuple(first)]),
            cpu=int(wgen[0][tuple(first)]),
            card_score=float(ggen[1][tuple(first[:2])]),
            cpu_score=float(wgen[1][tuple(first[:2])]))
        failures.append('beam ids differ at %s' % first)
    if not score_rel <= 1e-4:
        failures.append('beam scores off by %g' % score_rel)
    emit(out)
    if failures:
        raise AssertionError('machine_translation on the card off the CPU: '
                             '%s' % '; '.join(failures))
    return counts


def nmt_fused_holds_runs(torch, fluid, exe, main, loss, init, batches,
                         stacked):
    """Phase 27 (c): one ``run_fused`` window of NMT_K steps against NMT_K
    ``run()`` calls on the same batches, and a second NMT_K ``run()``
    calls against the first, each from a scope of ``init``: the last loss
    (what ``run_fused`` returns) and every state tensor (parameters, Adam
    moments and powers) equal bit for bit. The step's gathers that repeat
    rows add their gradients in index order on the card
    (paddle_tpu_torch/ops/sequence_ops.py `gather_rows`)."""
    from paddle_tpu_torch.io import scope_from_numpy
    runs = {}
    for side in ('run', 'run_again', 'fused'):
        scope = scope_from_numpy(init, device=exe.device)
        if side == 'fused':
            last = exe.run_fused(main, stacked, fetch_list=[loss],
                                 scope=scope, steps=NMT_K)[0]
        else:
            for b in batches:
                last = exe.run(main, feed=b, fetch_list=[loss],
                               scope=scope)[0]
        runs[side] = (np.asarray(last).reshape(-1), state_arrays(scope))
        del scope
        torch.cuda.empty_cache()
    want, wstate = runs['run']
    out, failures = dict(steps=NMT_K, tensors=len(wstate)), []
    for side in ('fused', 'run_again'):
        got, gstate = runs[side]
        off = sorted(n for n in wstate if n not in gstate or
                     not np.array_equal(gstate[n], wstate[n]))
        loss_equal = bool(np.array_equal(got, want))
        out[side + '_vs_run'] = dict(bitwise=not off and loss_equal,
                                     loss_equal=loss_equal,
                                     tensors_off=len(off),
                                     first_off=off[:3])
        if off or not loss_equal:
            failures.append('%s: loss %s against %s, %d tensors off (%s)'
                            % (side, got, want, len(off), off[:3]))
    if failures:
        raise AssertionError('machine_translation: run_fused over %d steps '
                             'and run() calls are not bitwise: %s'
                             % (NMT_K, '; '.join(failures)))
    return out


def nmt_train(torch, kt, fluid, smi, exe, main, startup, loss, feeds):
    """Phase 27 (b)-(d): the row's training at full width, eagerly and in
    run_fused windows of NMT_K steps. Returns (summary, launch counts)."""
    dev = exe.device
    cfg = nmt_config()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    init = state_arrays(scope)
    rng = np.random.RandomState(0)
    batches = nmt_batches(rng, feeds, cfg.dict_size, [NMT_L] * NMT_B, NMT_K,
                          to=lambda a: torch.from_numpy(a).to(dev))
    per_step = dict.fromkeys(kt.KERNELS, 0)
    per_step['embedding_gather'] = 2
    step = lambda i: exe.run(main, feed=batches[i % NMT_K],
                             fetch_list=[loss], scope=scope,
                             return_numpy=False)[0]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kt.reset_counts()
    t0 = time.perf_counter()
    losses = []
    for i in range(NMT_EAGER_STEPS):
        losses.append(step(i))
        if i == 0:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = kt.launch_counts()
    want = {k: NMT_EAGER_STEPS * v for k, v in per_step.items()}
    if counts != want:
        raise AssertionError('machine_translation: %d eager steps launched '
                             '%s, not %s' % (NMT_EAGER_STEPS, counts, want))
    eager = dict(steps=NMT_EAGER_STEPS,
                 losses=[float(v) for v in torch.cat(losses).cpu()],
                 first_step_ms=(t1 - t0) * 1e3,
                 step_ms=(t2 - t1) * 1e3 / (NMT_EAGER_STEPS - 1),
                 peak_mem_bytes=torch.cuda.max_memory_allocated() - base)
    kt.reset_counts()
    eager['step_profile'] = step_profile(torch, lambda: step(0), steps=1,
                                         host=True)
    extra = kt.launch_counts()
    counts = {k: counts[k] + extra[k] for k in counts}

    lod = batches[0][feeds[0]][1]
    stacked = {n: (torch.stack([b[n][0] for b in batches]), lod)
               for n in feeds}
    run = lambda steps, **kw: exe.run_fused(
        main, stacked, fetch_list=[loss], scope=scope, steps=steps, **kw)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    fused_losses = [float(run(NMT_K)[0].reshape(-1)[0])]
    first_s = time.perf_counter() - t
    plan = [e.bound[scope] for _, e in exe._cache.items()
            if scope in e.bound][-1]
    kt.reset_counts()
    best = float('inf')
    for _ in range(NMT_FUSED_ROUNDS):
        t = time.perf_counter()
        last = run(NMT_K, return_numpy=False)
        fused_losses.append(float(last[0].reshape(-1)[0]))      # the sync
        best = min(best, time.perf_counter() - t)
    fcounts = kt.launch_counts()
    want = {k: NMT_FUSED_ROUNDS * NMT_K * v for k, v in per_step.items()}
    if fcounts != want:
        raise AssertionError('machine_translation: %d fused steps launched '
                             '%s, not %s' % (NMT_FUSED_ROUNDS * NMT_K,
                                             fcounts, want))
    fused = dict(k_batches=NMT_K, steps_per_call=NMT_K,
                 rounds=NMT_FUSED_ROUNDS, first_call_s=first_s,
                 step_ms=best / NMT_K * 1e3, losses=fused_losses,
                 replays=plan.replays, captures=plan.captures,
                 peak_mem_bytes=torch.cuda.max_memory_allocated() - base)
    if plan.captures != 1:
        raise AssertionError('machine_translation: run_fused captured %d '
                             'graphs' % plan.captures)
    kt.reset_counts()
    fused['window_profile'] = step_profile(
        torch, lambda: run(NMT_K, return_numpy=False)[0].cpu(), steps=1)
    copies, kernels, _, _ = htod_copies(torch, lambda: run(
        2, return_numpy=False)[0].cpu())
    fused['htod_copies_in_2_steps'] = copies
    fused['device_kernels_in_2_steps'] = kernels
    if copies:
        raise AssertionError('machine_translation: %d host-to-device copies '
                             'in two fused steps' % copies)
    extra = kt.launch_counts()
    counts = {k: counts[k] + fcounts[k] + extra[k] for k in counts}
    del plan
    fused['holds_runs'] = nmt_fused_holds_runs(
        torch, fluid, exe, main, loss, init, batches, stacked)
    del init
    prof, wprof = eager['step_profile'], fused['window_profile']
    tokens = NMT_B * NMT_L
    out = dict(
        phase='nmt_train', card=smi, batch=NMT_B, seq_len=NMT_L,
        vocab=cfg.dict_size, width=cfg.decoder_size,
        ops=len(main.global_block().ops),
        step_block_ops=len(main.block(1).ops),
        param_count=int(sum(np.prod(p.shape)
                            for p in main.all_parameters())),
        step_ms=fused['step_ms'], eager_step_ms=eager['step_ms'],
        tokens_per_s=tokens / (fused['step_ms'] / 1e3),
        eager_tokens_per_s=tokens / (eager['step_ms'] / 1e3),
        samples_per_s=NMT_B / (fused['step_ms'] / 1e3),
        launches_per_step=prof['launches_per_step'],
        eager_device_ms=prof['device_ms_per_step'],
        eager_busy_share=prof['busy_share'],
        device_ms=wprof['device_ms_per_step'] / NMT_K,
        busy_share=wprof['busy_share'],
        peak_mem_bytes=max(eager['peak_mem_bytes'],
                           fused['peak_mem_bytes']),
        launches_per_step_hand_written=per_step,
        loss_first=eager['losses'][0], loss_last=fused_losses[-1],
        eager=eager, fused=fused)
    out['loss_fell'] = out['loss_last'] < out['loss_first']
    trail = eager['losses'] + fused_losses
    if not all(np.isfinite(trail)) or not out['loss_fell']:
        emit(out)
        raise AssertionError('machine_translation: the loss is not finite '
                             'and falling: %s' % trail)
    return out, counts


def nmt_generate(torch, kt, fluid, smi, exe, gmain, gstartup, gfetch):
    """Phase 27 (e): the row's beam generation through ``bind``: one
    capture (the loop one WHILE node of the graph), replays timed (ms a
    sentence), no host-to-device copy in a replay, the replay's ids equal
    to an eager ``run()``'s on the card. Each call launches the gather
    1 + GEN_MAX_LEN times (the source, and the target embedding in each of
    the loop's trips, which the loop's trip counter reads back:
    ``BoundProgram.loop_launches``) and no other kernel. Returns (summary,
    launch counts of the replays)."""
    dev = exe.device
    cfg = nmt_config()
    gscope = fluid.Scope()
    exe.run(gstartup, scope=gscope)
    feed = gen_feed(np.random.RandomState(1), cfg.dict_size, GEN_B, GEN_BEAM,
                    NMT_L, to=lambda a: torch.from_numpy(a).to(dev))
    torch.cuda.synchronize()
    t = time.perf_counter()
    bound = exe.bind(gmain, feed, fetch_list=gfetch, scope=gscope)
    bind_s = time.perf_counter() - t
    kt.reset_counts()
    best, outs = float('inf'), []
    for _ in range(GEN_ROUNDS):
        t = time.perf_counter()
        outs.append(bound(bound.example_feed))                # reads: sync
        best = min(best, time.perf_counter() - t)
    copies, kernels, wall_ms, dev_ms = htod_copies(
        torch, lambda: bound(bound.example_feed))
    loop_counts, trips = bound.loop_launches()
    counts = kt.launch_counts()
    want = dict.fromkeys(kt.KERNELS, 0)
    want['embedding_gather'] = (GEN_ROUNDS + 1) * (1 + GEN_MAX_LEN)
    torch.cuda.synchronize()
    t = time.perf_counter()
    eager = exe.run(gmain, feed=feed, fetch_list=gfetch, scope=gscope)
    eager_ms = (time.perf_counter() - t) * 1e3
    ids, scores = outs[-1]
    out = dict(
        phase='nmt_generate', card=smi, batch=GEN_B, beam=GEN_BEAM,
        max_len=GEN_MAX_LEN, source_len=NMT_L, bind_s=bind_s,
        call_ms=best * 1e3, ms_per_sentence=best * 1e3 / GEN_B,
        eager_call_ms=eager_ms, captures=bound.captures,
        replays=bound.replays, launches_per_replay=bound.launches,
        device_kernels_a_replay=kernels, device_ms_a_replay=dev_ms,
        replay_wall_ms=wall_ms, htod_copies_in_a_replay=copies,
        gather_launches_a_call=counts['embedding_gather'] /
        (GEN_ROUNDS + 1), loop_trips=trips, loop_body_launches=loop_counts,
        ids_shape=list(ids.shape),
        replay_equals_eager=bool(np.array_equal(ids, eager[0]) and
                                 np.array_equal(scores, eager[1])),
        replays_agree=all(np.array_equal(o[0], ids) for o in outs),
        scores_finite=bool(np.isfinite(scores).all()),
        first_sentence=[int(v) for v in ids[0, 0, :12]])
    emit(out)
    failures = []
    if bound.captures != 1:
        failures.append('%d captures' % bound.captures)
    if trips != [(GEN_ROUNDS + 1) * GEN_MAX_LEN]:
        failures.append('the loop ran %s trips in %d replays'
                        % (trips, GEN_ROUNDS + 1))
    if counts != want:
        failures.append('%d calls launched %s, not %s'
                        % (GEN_ROUNDS + 1, counts, want))
    if copies:
        failures.append('%d host-to-device copies in a replay' % copies)
    if list(ids.shape) != [GEN_B, GEN_BEAM, GEN_MAX_LEN]:
        failures.append('ids of shape %s' % list(ids.shape))
    if not (out['replay_equals_eager'] and out['replays_agree'] and
            out['scores_finite']):
        failures.append('the replays are off the eager run or not finite')
    if failures:
        raise AssertionError('machine_translation generation: %s'
                             % '; '.join(failures))
    return out, counts


def run_nmt(torch, kt, smi):
    """Phase 27 (module docstring). Returns {path: launch counts}."""
    import paddle_tpu_torch as fluid
    by_path = {'nmt_hold': nmt_hold(torch, kt, fluid, smi)}
    torch.cuda.empty_cache()
    exe = fluid.Executor()
    t = time.perf_counter()
    main, startup, loss, feeds, gmain, gstartup, gfetch = nmt_programs(
        fluid, nmt_config(), GEN_MAX_LEN)
    build_s = time.perf_counter() - t
    train, by_path['nmt_train'] = nmt_train(torch, kt, fluid, smi, exe, main,
                                            startup, loss, feeds)
    train['build_s'] = build_s
    emit(train)
    del train
    torch.cuda.empty_cache()
    _, by_path['nmt_generate'] = nmt_generate(torch, kt, fluid, smi, exe,
                                              gmain, gstartup, gfetch)
    exe.close()
    torch.cuda.empty_cache()
    return by_path


def engine_prompts():
    """Phase 4's 16 prompts (lengths 5..256, drawn as phase 4 draws
    them)."""
    rs = np.random.RandomState(7)
    lens = np.linspace(5, BUCKETS[-1], N_REQUESTS).astype(int)
    return [rs.randint(2, 32000, size=int(n)) for n in lens]


def bucket_of(n):
    return min(b for b in BUCKETS if b >= n)


class BoundPrograms(object):
    """The decode programs of one scope, each bound at its first call
    (``Executor.bind``: that call's step runs eagerly, the next one is
    captured) and replayed after it; calls return the fetches on the
    card."""

    def __init__(self, torch, exe, scope):
        self.torch, self.exe, self.scope = torch, exe, scope
        self.bound = {}

    def __call__(self, key, prog, fetch, feed):
        bp = self.bound.get(key)
        if bp is None:
            bp = self.bound[key] = self.exe.bind(prog, feed, fetch_list=fetch,
                                                 scope=self.scope)
            return [self.torch.from_numpy(np.asarray(o)).to(self.exe.device)
                    for o in bp.first_out]
        return bp(feed, return_numpy=False)

    def summary(self):
        return {str(k): dict(captures=bp.captures, replays=bp.replays,
                             launches_a_replay=bp.launches)
                for k, bp in sorted(self.bound.items(), key=str)}


def zero_sampling(torch, rows, dev):
    """The sampling quad of ``rows`` greedy rows, on the card."""
    f = lambda dt: torch.zeros((rows, 1), dtype=dt, device=dev)
    return {'gen_temp': f(torch.float32), 'gen_topk': f(torch.int64),
            'gen_topp': f(torch.float32), 'gen_u': f(torch.float32)}


def decode_program_scope(torch, fluid, params, cache_shape, dev):
    """A scope of the engine's weights (copies) and zeroed caches."""
    from paddle_tpu_torch.io import scope_from_numpy
    from paddle_tpu_torch.models.transformer import KV_CACHE_K, KV_CACHE_V
    scope = scope_from_numpy(params, device=dev)
    for n in (KV_CACHE_K, KV_CACHE_V):
        scope.set(n, torch.zeros(cache_shape, dtype=torch.float32,
                                 device=dev))
    return scope


def dev_place(fluid, dev):
    return fluid.CPUPlace() if dev.type == 'cpu' else fluid.CUDAPlace(0)


def program_of(fluid, build):
    """(program, the variables ``build()`` returns) of ``build()`` run under
    a new program's guard."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        v = build()
    return main, v


def hold_program_tokens(got, refs, logits, what):
    """Each request's tokens against the engine's: equal, or first apart
    at a tie of the program's logits (within TIE); returns the ties."""
    ties = []
    for i, (g, r) in enumerate(zip(got, refs)):
        tie = first_tie(list(g), list(r[:len(g)]), logits[i])
        if tie:
            ties.append(dict(tie, request=i))
    if ties:
        emit(dict(phase='decode_program_tie', what=what, ties=ties))
    return ties


def serve_contiguous(torch, fluid, cfg, params, prompts, dev):
    """Phase 28 (a): the 16 prompts through the bound contiguous programs,
    in two waves of SLOTS: each prompt prefilled into its slot through
    its bucket's program, then NEW_TOKENS - 1 decode steps for the wave,
    the tokens fed back on the card. Returns (tokens, logits each token
    was chosen from, the bound programs, the programs, the scope)."""
    from paddle_tpu_torch.models.transformer import (KV_CACHE_K,
                                                     build_lm_decode_step,
                                                     build_lm_prefill)
    dh = cfg.d_model // cfg.n_head
    scope = decode_program_scope(torch, fluid, params, (
        SLOTS, cfg.n_layer, cfg.n_head, MAX_LEN, dh), dev)
    cache = scope.get(KV_CACHE_K)
    progs = {b: program_of(fluid, lambda b=b: build_lm_prefill(
        cfg, b, SLOTS, MAX_LEN)) for b in BUCKETS}
    step_prog, sv = program_of(fluid, lambda: build_lm_decode_step(
        cfg, SLOTS, MAX_LEN))
    run = BoundPrograms(torch, fluid.Executor(dev_place(fluid, dev)), scope)
    tokens, logits = [None] * len(prompts), [None] * len(prompts)
    for w in range(0, len(prompts), SLOTS):
        wave = list(range(w, min(w + SLOTS, len(prompts))))
        first = torch.zeros(SLOTS, dtype=torch.int64, device=dev)
        pos = np.zeros(SLOTS, 'int64')
        lg = [[] for _ in wave]
        for s, i in enumerate(wave):
            p = prompts[i]
            b = bucket_of(len(p))
            main, v = progs[b]
            padded = np.zeros((1, b), 'int64')
            padded[0, :len(p)] = p
            feed = {'gen_prompt': padded,
                    'gen_slot': np.array([[s]], 'int64'),
                    'gen_len': np.array([[len(p)]], 'int64')}
            feed.update({n: t[:1].cpu().numpy() for n, t in
                         zero_sampling(torch, 1, dev).items()})
            tok, lgt = run(('prefill', b), main,
                           [v['first_token'], v['logits']], feed)
            first[s] = tok.reshape(-1)[0]
            lg[s].append(lgt[0])
            pos[s] = len(p)
        out = [first.clone()]
        tok = first
        posd = torch.from_numpy(pos).to(dev)
        sample = zero_sampling(torch, SLOTS, dev)
        for _ in range(NEW_TOKENS - 1):
            feed = dict(sample, gen_tokens=tok.reshape(SLOTS, 1),
                        gen_pos=posd.reshape(SLOTS, 1))
            tok, lgt = run('step', step_prog,
                           [sv['next_tokens'], sv['logits']], feed)
            out.append(tok)
            for s in range(len(wave)):
                lg[s].append(lgt[s])
            posd = posd + 1
        toks = torch.stack(out, 1).cpu().numpy()
        for s, i in enumerate(wave):
            tokens[i] = [int(t) for t in toks[s]]
            logits[i] = [t.cpu() for t in lg[s]]
    if scope.get(KV_CACHE_K) is not cache:
        raise AssertionError('decode programs: the scope\'s cache was '
                             'replaced (copied) by a step')
    return tokens, logits, run, (progs, step_prog, sv), scope


def block_tables(lens, extra, rows):
    """Phase 4b's pool cut into each request's blocks, in order from block
    1 (0 is the trash block): ``lens[i] + extra`` rows each; [len(lens),
    MAX_LEN // PAGED_BLOCK] int64."""
    mb = MAX_LEN // PAGED_BLOCK
    tab = np.zeros((rows, mb), 'int64')
    at = 1
    for i, n in enumerate(lens):
        k = -(-(int(n) + extra) // PAGED_BLOCK)
        tab[i, :k] = np.arange(at, at + k)
        at += k
    if at > PAGED_BLOCKS:
        raise AssertionError('the requests need %d blocks of %d'
                             % (at, PAGED_BLOCKS))
    return tab


def serve_paged(torch, fluid, cfg, params, prompts, dev):
    """Phase 28 (b): the 16 prompts through the bound paged programs, one
    wave of PAGED_SLOTS (each request's blocks from `block_tables`), then
    one speculative round: the drafter (SPEC_K greedy steps of the same
    weights) and the verify step over the drafts. Returns (tokens, logits,
    the accepted tokens of the round and their count a request, the
    bound programs)."""
    from paddle_tpu_torch.models.transformer import (
        build_lm_decode_step, build_lm_drafter, build_lm_prefill_paged,
        build_lm_verify)
    dh = cfg.d_model // cfg.n_head
    mb = MAX_LEN // PAGED_BLOCK
    S, W = PAGED_SLOTS, SPEC_K + 1
    scope = decode_program_scope(torch, fluid, params, (
        PAGED_BLOCKS, cfg.n_layer, cfg.n_head, PAGED_BLOCK, dh), dev)
    tab = block_tables([len(p) for p in prompts], NEW_TOKENS + W, S)
    tabd = torch.from_numpy(tab).to(dev)
    progs = {b: program_of(fluid, lambda b=b: build_lm_prefill_paged(
        cfg, b, PAGED_BLOCKS, PAGED_BLOCK, mb)) for b in BUCKETS}
    step_prog, sv = program_of(fluid, lambda: build_lm_decode_step(
        cfg, S, MAX_LEN, block_size=PAGED_BLOCK, num_blocks=PAGED_BLOCKS))
    draft_prog, dv = program_of(fluid, lambda: build_lm_drafter(
        cfg, S, MAX_LEN, SPEC_K, PAGED_BLOCKS, PAGED_BLOCK))
    verify_prog, vv = program_of(fluid, lambda: build_lm_verify(
        cfg, S, W, MAX_LEN, PAGED_BLOCKS, PAGED_BLOCK))
    run = BoundPrograms(torch, fluid.Executor(dev_place(fluid, dev)), scope)
    first = torch.zeros(S, dtype=torch.int64, device=dev)
    lg = [[] for _ in prompts]
    for i, p in enumerate(prompts):
        b = bucket_of(len(p))
        main, v = progs[b]
        padded = np.zeros((1, b), 'int64')
        padded[0, :len(p)] = p
        feed = {'gen_prompt': padded,
                'gen_pos': np.arange(b, dtype='int64')[None],
                'gen_btab': tab[i:i + 1],
                'gen_len': np.array([[len(p)]], 'int64')}
        feed.update({n: t[:1].cpu().numpy() for n, t in
                     zero_sampling(torch, 1, dev).items()})
        tok, lgt = run(('prefill_paged', b), main,
                       [v['first_token'], v['logits']], feed)
        first[i] = tok.reshape(-1)[0]
        lg[i].append(lgt[0])
    out, tok = [first.clone()], first
    posd = torch.tensor([len(p) for p in prompts], dtype=torch.int64,
                        device=dev)
    sample = zero_sampling(torch, S, dev)
    for _ in range(NEW_TOKENS - 1):
        feed = dict(sample, gen_tokens=tok.reshape(S, 1),
                    gen_pos=posd.reshape(S, 1), gen_btab=tabd)
        tok, lgt = run('step_paged', step_prog,
                       [sv['next_tokens'], sv['logits']], feed)
        out.append(tok)
        for i in range(len(prompts)):
            lg[i].append(lgt[i])
        posd = posd + 1
    ones = torch.ones((S, W), dtype=torch.int64, device=dev)
    drafts, = run('drafter', draft_prog, [dv['draft_tokens']], dict(
        gen_tokens=tok.reshape(S, 1), gen_pos=posd.reshape(S, 1),
        gen_btab=tabd, gen_vmask=ones))
    vpos = torch.clamp(posd[:, None] + torch.arange(W, device=dev),
                       max=MAX_LEN - 1)
    verdict, _ = run('verify', verify_prog,
                     [vv['verify_tokens'], vv['logits']], dict(
                         gen_tokens=torch.cat([tok[:, None], drafts], 1),
                         gen_pos=vpos, gen_btab=tabd, gen_vmask=ones))
    drafts, verdict = drafts.cpu().numpy(), verdict.reshape(S, W).cpu().numpy()
    accepted = []
    for s in range(S):
        n = 0
        while n < SPEC_K and drafts[s, n] == verdict[s, n]:
            n += 1
        accepted.append([int(t) for t in drafts[s, :n]] +
                        [int(verdict[s, n])])
    toks = torch.stack(out, 1).cpu().numpy()
    tokens = [[int(t) for t in toks[i]] for i in range(len(prompts))]
    logits = [[t.cpu() for t in l] for l in lg]
    return tokens, logits, accepted, run


def bound_step_ms(torch, run, key, feed):
    """(host ms a call at numpy ``feed``, reading the first fetch; device
    ms a replay) of the bound program ``key``."""
    bp = run.bound[key]
    host = host_ms(torch, lambda: bp(feed, return_numpy=False)[0].cpu(), 20)
    return host, replay_ms(torch, bp.graph, 1, 20)


def run_decode_programs(torch, kt, smi):
    """Phase 28: the decode engine's five program-building functions bound
    on the card at full width, held to the engines' tokens on the same
    weights. Returns {path: launch counts}."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.serving import GenerateConfig, GenerateEngine
    from paddle_tpu_torch.models.transformer import LMConfig
    cfg = LMConfig(dropout=0.0, attn_dropout=0.0, use_flash_attention=True)
    prompts = engine_prompts()
    eng = GenerateEngine(GenerateConfig(
        model=cfg, slots=SLOTS, max_len=MAX_LEN,
        prompt_buckets=list(BUCKETS), max_new_tokens=NEW_TOKENS, seed=0))
    eng.warmup()
    refs = [eng.generate_once(p, max_new_tokens=NEW_TOKENS)
            for p in prompts]
    params = {n: p for n, p in eng.model.p.items()}
    out, by_path, failures = dict(phase='decode_programs', card=smi), {}, []

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kt.reset_counts()
    t = time.perf_counter()
    tokens, logits, run, progs, scope = serve_contiguous(
        torch, fluid, cfg, params, prompts, torch.device('cuda', 0))
    torch.cuda.synchronize()
    out['serve_s'] = time.perf_counter() - t
    by_path['decode_programs'] = kt.launch_counts()
    out['peak_mem_bytes'] = torch.cuda.max_memory_allocated() - base
    out['ties'] = hold_program_tokens(tokens, refs, logits, 'contiguous')
    out['tokens_equal_engine'] = sum(
        list(g) == list(r) for g, r in zip(tokens, refs))
    out['bound'] = run.summary()
    for key, bp in run.bound.items():
        want = PROGRAM_STEP_KERNELS if key == 'step' else \
            PROGRAM_PREFILL_KERNELS
        if bp.captures != 1 or bp.launches != want:
            failures.append('%s: %d captures, launches a replay %s, not %s'
                            % (key, bp.captures, bp.launches, want))
    # a bound step and the engine's graphed step at one state (phase 4's
    # timing feeds), in turns; then a replay's host-to-device copies with
    # the feeds already on the card
    rs = np.random.RandomState(28)
    ekey = ('step', False)
    efeeds = signature_feeds(eng, ekey, rs)
    pfeed = {'gen_tokens': efeeds[0].reshape(SLOTS, 1),
             'gen_pos': efeeds[1].reshape(SLOTS, 1)}
    pfeed.update({n: t.cpu().numpy() for n, t in
                  zero_sampling(torch, SLOTS, torch.device('cuda')).items()})
    graphed, _ = graphed_and_eager(torch, eng, ekey, efeeds)
    timing = {}
    for name in ('program', 'engine', 'engine_again', 'program_again'):
        if name.startswith('program'):
            timing[name] = bound_step_ms(torch, run, 'step', pfeed)
        else:
            timing[name] = (host_ms(torch, graphed, 20),
                            graph_device_ms(torch, eng, ekey))
    out['step_ms'] = {k: dict(host=v[0], device=v[1])
                      for k, v in timing.items()}
    dfeed = {n: torch.from_numpy(np.ascontiguousarray(a)).cuda()
             for n, a in pfeed.items()}
    copies, kernels, _, _ = htod_copies(
        torch, lambda: run.bound['step'](dfeed, return_numpy=False))
    out['step_htod_copies_a_replay'] = copies
    out['step_device_kernels_a_replay'] = kernels
    # where a replay's device time goes, the bound step's and the engine's
    out['step_profile'] = dict(
        program=step_profile(torch, lambda: run.bound['step'](
            dfeed, return_numpy=False)[0].cpu()),
        engine=step_profile(torch, graphed))
    b = BUCKETS[-1]
    main, v = progs[0][b]
    pre = {'gen_prompt': rs.randint(2, cfg.vocab_size, (1, b)),
           'gen_slot': np.array([[0]]), 'gen_len': np.array([[b]])}
    pre = {n: torch.from_numpy(a.astype('int64')).cuda()
           for n, a in pre.items()}
    pre.update(zero_sampling(torch, 1, torch.device('cuda')))
    copies_p, _, _, _ = htod_copies(
        torch, lambda: run.bound[('prefill', b)](pre, return_numpy=False))
    out['prefill_htod_copies_a_replay'] = copies_p
    out['prefill_ms'] = {str(b): dict(zip(('host', 'device'), bound_step_ms(
        torch, run, ('prefill', b), {n: t.cpu().numpy()
                                     for n, t in pre.items()})))}
    if copies or copies_p:
        failures.append('%d and %d host-to-device copies in a step and a '
                        'prefill replay' % (copies, copies_p))
    del run, progs, scope, eng
    torch.cuda.empty_cache()

    # (b) the paged programs and one speculative round, held to a paged
    # engine of the same weights (greedy, NEW_TOKENS + SPEC_K + 1 tokens)
    peng = GenerateEngine(paged_config())
    for n, p in peng.model.p.items():
        if not torch.equal(p, params[n]):
            raise AssertionError('the paged engine\'s %s differs' % n)
    peng.warmup()
    prefs = [peng.generate_once(p, max_new_tokens=NEW_TOKENS + SPEC_K + 1)
             for p in prompts]
    del peng
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kt.reset_counts()
    t = time.perf_counter()
    ptokens, plogits, accepted, prun = serve_paged(
        torch, fluid, cfg, params, prompts, torch.device('cuda', 0))
    torch.cuda.synchronize()
    paged = dict(serve_s=time.perf_counter() - t,
                 peak_mem_bytes=torch.cuda.max_memory_allocated() - base)
    by_path['decode_programs_paged'] = kt.launch_counts()
    paged['ties'] = hold_program_tokens(ptokens, prefs, plogits, 'paged')
    paged['tokens_equal_engine'] = sum(
        list(g) == list(r[:NEW_TOKENS]) for g, r in zip(ptokens, prefs))
    paged['accepted'] = [len(a) - 1 for a in accepted]
    # a request whose tokens parted at a tie continues from other tokens
    tied = set(t['request'] for t in paged['ties'])
    paged['accepted_off_engine'] = [
        i for i, (a, r) in enumerate(zip(accepted, prefs))
        if a != list(r[NEW_TOKENS:NEW_TOKENS + len(a)])]
    paged['accepted_equal_engine'] = N_REQUESTS - len(
        paged['accepted_off_engine'])
    paged['bound'] = prun.summary()
    for key, bp in prun.bound.items():
        if bp.captures != 1:
            failures.append('%s: %d captures' % (key, bp.captures))
    for key, bp in prun.bound.items():
        want = PROGRAM_DRAFTER_KERNELS if key == 'drafter' else \
            PROGRAM_PAGED_PREFILL_KERNELS if isinstance(key, tuple) else \
            PROGRAM_STEP_KERNELS
        if bp.launches != want:
            failures.append('%s: launches a replay %s, not %s'
                            % (key, bp.launches, want))
    S = PAGED_SLOTS
    tab = block_tables([len(p) for p in prompts], NEW_TOKENS + SPEC_K + 1, S)
    feed = {'gen_tokens': efeeds[0][:1].repeat(S).reshape(S, 1),
            'gen_pos': np.full((S, 1), MAX_LEN // 2, 'int64'),
            'gen_btab': tab}
    feed.update({n: t.cpu().numpy() for n, t in
                 zero_sampling(torch, S, torch.device('cuda')).items()})
    paged['step_ms'] = dict(zip(('host', 'device'), bound_step_ms(
        torch, prun, 'step_paged', feed)))
    dfeed = {n: torch.from_numpy(np.ascontiguousarray(a)).cuda()
             for n, a in feed.items()}
    paged['step_htod_copies_a_replay'], _, _, _ = htod_copies(
        torch, lambda: prun.bound['step_paged'](dfeed, return_numpy=False))
    if paged['step_htod_copies_a_replay']:
        failures.append('%d host-to-device copies in a paged step replay'
                        % paged['step_htod_copies_a_replay'])
    out['paged'] = paged
    del prun
    torch.cuda.empty_cache()
    emit(out)
    for what, res, n in (('contiguous', out, N_REQUESTS),
                         ('paged', paged, N_REQUESTS)):
        if res['tokens_equal_engine'] + len(res['ties']) != n:
            failures.append('%s: %d of %d requests equal the engine\'s '
                            'tokens' % (what, res['tokens_equal_engine'], n))
    off = [i for i in paged['accepted_off_engine'] if i not in tied]
    if off:
        failures.append('speculative round: the accepted tokens of requests '
                        '%s, which parted at no tie, differ from the '
                        'engine\'s' % off)
    if failures:
        raise AssertionError('decode programs: %s' % '; '.join(failures))
    return by_path

# ---------------------------------------------------------------------------
# phase 29: the observability tier on the main paths


def example_product_flops(cfg, batch):
    """The product flops of one step of examples/train_lm.py's AMP program
    at ``cfg`` and ``batch`` by analysis.py's rule: per layer the QKV and
    projection products (forward, and dX and dW each as two bf16 products
    under the AMP mark: 5x), the FFN's two (its plain backward's four: 3x)
    and flash attention's two over the full L x L (its plain backward's
    seven: 9x); the LM head like the QKV product."""
    n = batch * cfg.seq_len
    d, f, v, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.seq_len
    layer = 5 * (2 * n * d * 3 * d + 2 * n * d * d) + \
        3 * (2 * n * d * f + 2 * n * f * d) + 9 * (2 * batch * L * L * d)
    return cfg.n_layer * layer + 5 * (2 * n * d * v)


def prom_lines(text):
    """The exposition's sample lines but those of the wall-clock gauges."""
    return [ln for ln in text.splitlines()
            if ln and not ln.startswith('#') and
            not ln.split('{')[0].split(' ')[0] in OBS_WALL_GAUGES]


def prom_value(text, series):
    """The value of one sample line (name with its labels as exposed)."""
    for ln in text.splitlines():
        if ln.startswith(series + ' '):
            return float(ln.rsplit(' ', 1)[1])
    return None


def obs_engine(torch, kt, smi):
    """Phase 29 (a) and (c): phase 4's engine and requests with the metrics
    endpoint; then the bound decode step's host ms, hooks on and off."""
    import urllib.request
    from paddle_tpu_torch import goodput, monitor
    from paddle_tpu_torch.models.transformer import LMConfig
    from paddle_tpu_torch.serving import GenerateConfig, GenerateEngine
    cfg = GenerateConfig(
        model=LMConfig(dropout=0.0, attn_dropout=0.0,
                       use_flash_attention=True),
        slots=SLOTS, max_len=MAX_LEN, prompt_buckets=list(BUCKETS),
        max_new_tokens=NEW_TOKENS, seed=0, metrics_port=0)
    work = engine_work(np.random.RandomState(7), cfg.model.vocab_size)
    eng = GenerateEngine(cfg)
    eng.warmup()
    kt.reset_counts()
    with eng:
        base = 'http://127.0.0.1:%d' % eng.metrics_port
        reqs = [eng.submit(p, max_new_tokens=NEW_TOKENS, **kw)
                for p, kw in work]
        outs = [r.result(600) for r in reqs]
        goodput.stats()         # drains the dispatches before the scrape
        scrape = urllib.request.urlopen(base + '/metrics',
                                        timeout=30).read().decode()
        text = monitor.export_prometheus()
        health = urllib.request.urlopen(base + '/healthz',
                                        timeout=30).read().decode()
    counts = kt.launch_counts()
    stats = eng.stats()
    tokens = sum(len(o) for o in outs)
    shares = []
    for o in outs:
        t = o.timing
        stages = sum(v for k, v in t.items() if k.endswith('_s') and
                     k not in ('total_s', 'step_s_mean', 'step_s_p99'))
        shares.append(stages / t['total_s'])
    out = dict(
        engine_requests=len(outs), tokens=tokens, healthz=health.strip(),
        scrape_lines=len(prom_lines(scrape)),
        scrape_equals_export=prom_lines(scrape) == prom_lines(text),
        requests_ok=prom_value(scrape,
                               'generate_request_total{outcome="ok"}'),
        decode_tokens_total=prom_value(scrape, 'decode_tokens_total'),
        captures_after_warmup=stats['graphs']['captures_after_warmup'],
        stage_share=dict(min=min(shares), mean=sum(shares) / len(shares),
                         max=max(shares)),
        timing_keys=sorted(outs[0].timing),
        engine_goodput={k: stats['goodput'][k] for k in (
            'dispatches', 'productive_s', 'goodput_frac')})
    failures = []
    if not out['scrape_equals_export']:
        a, b = set(prom_lines(scrape)), set(prom_lines(text))
        failures.append('the /metrics scrape differs from export_prometheus: '
                        'only scraped %s, only exported %s'
                        % (sorted(a - b), sorted(b - a)))
    if out['healthz'] != 'ok':
        failures.append('/healthz answered %r' % out['healthz'])
    if out['requests_ok'] != N_REQUESTS or '"deadline"' in scrape or \
            '"error"' in scrape:
        failures.append('requests counted %s' % out['requests_ok'])
    if out['decode_tokens_total'] != tokens:
        failures.append('decode_tokens_total %s for %d tokens'
                        % (out['decode_tokens_total'], tokens))
    if out['captures_after_warmup']:
        failures.append('%d captures after warmup'
                        % out['captures_after_warmup'])
    if max(shares) > 1.0 + 1e-9:
        failures.append('trace stages sum past the latency: %s' % shares)
    idle = [k for k in ENGINE_KERNELS if counts[k] <= 0]
    if idle:
        failures.append('kernels never launched: %s' % idle)
    # (c) the bound decode step (the engine's graphed step and its goodput
    # hook) with the hooks on and off, call by call
    out['hook_cost'] = dict(hook_cost(torch, eng), card=smi)
    del eng
    return out, counts, failures


def hook_cost(torch, eng):
    """Phase 29 (c): the host ms of each call of the engine's bound decode
    step, with the hooks on and off (``PADDLE_PERFWATCH=0``,
    ``PADDLE_TRACE=0``) in OBS_HOOK_PAIRS pairs of calls, the pair's order
    alternating. The rise is the ratio of the two modes' medians less 1,
    and its spread the range of the rises within each fifth of the
    pairs."""
    rows = {i: (5 + i, 100 + i, (0.0, 0, 0.0, 0.0)) for i in range(SLOTS)}
    keys = ('PADDLE_PERFWATCH', 'PADDLE_TRACE')
    saved = {k: os.environ.get(k) for k in keys}
    ms = {'on': [], 'off': []}
    eng._run_step(rows)
    try:
        for i in range(OBS_HOOK_PAIRS):
            for mode in (('on', 'off') if i % 2 == 0 else ('off', 'on')):
                for k in keys:
                    if mode == 'off':
                        os.environ[k] = '0'
                    else:
                        os.environ.pop(k, None)
                t = time.perf_counter()
                eng._run_step(rows)
                ms[mode].append((time.perf_counter() - t) * 1e3)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    med = {m: float(np.median(v)) for m, v in ms.items()}
    fifth = OBS_HOOK_PAIRS // 5
    rises = [float(np.median(ms['on'][j:j + fifth]) /
                   np.median(ms['off'][j:j + fifth]) - 1.0)
             for j in range(0, 5 * fifth, fifth)]
    return dict(pairs=OBS_HOOK_PAIRS, median_on_ms=med['on'],
                median_off_ms=med['off'],
                best_on_ms=min(ms['on']), best_off_ms=min(ms['off']),
                rise=med['on'] / med['off'] - 1.0, rise_by_fifth=rises,
                spread=max(rises) - min(rises))


def obs_train(torch, kt, smi):
    """Phase 29 (b): the example's AMP LM step through run_fused, with its
    counted flops, goodput and the profiler."""
    import tempfile
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import analysis, goodput, monitor, profiler
    from paddle_tpu_torch.models.transformer import LMConfig
    cfg = LMConfig(**EXAMPLE_LM)
    exe = fluid.Executor()
    dev = exe.device
    main, startup, lr, loss = example_program(fluid, cfg)
    types = [op.type for op in main.global_block().ops]
    per = dict(program_step_launches(cfg, amp=True),
               fused_adam=types.count('fused_adam'))
    rng = np.random.RandomState(1)
    stacked = {k: torch.from_numpy(rng.randint(
        0, cfg.vocab_size, (EXAMPLE_K, EXAMPLE_B, cfg.seq_len)).astype(
            'int64')).to(dev) for k in ('tokens', 'labels')}
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    window = lambda steps: exe.run_fused(
        main, stacked, fetch_list=[loss], scope=scope, steps=steps,
        return_numpy=False)
    # the plan's peak is its first step's new peak over the base: the
    # statistics are this phase's to reset (analysis.py never does)
    torch.cuda.reset_peak_memory_stats()
    window(2)                   # the eager first step, the capture, a replay
    goodput.reset()             # a window of the timed steps alone
    kt.reset_counts()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    t = time.perf_counter()
    for _ in range(OBS_WINDOWS):
        last = window(OBS_WINDOW)
    ev[1].record()
    loss_v = float(last[0].reshape(-1)[0])
    wall_s = time.perf_counter() - t
    counts = kt.launch_counts()
    fp = main._fingerprint()
    st = goodput.stats(fps={fp})
    with tempfile.TemporaryDirectory() as tmp:
        with profiler.profiler('All', profile_path=os.path.join(tmp, 'p')):
            torch.cuda.synchronize()
            t = time.perf_counter()
            float(window(OBS_PROFILED)[0].reshape(-1)[0])
            prof_wall_ms = (time.perf_counter() - t) * 1e3
    device = [e for e in profiler.last_session().key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    prof_dev_ms = sum(e.self_device_time_total for e in device) / 1e3
    rec = analysis.lookup(main)
    closed = example_product_flops(cfg, EXAMPLE_B)
    gauges = monitor.snapshot()['gauges']
    peak_key = 'program_peak_bytes{fingerprint=%s,kind=%s}' % (fp[:12],
                                                               rec.kind)
    steps = OBS_WINDOWS * OBS_WINDOW
    out = dict(
        config=EXAMPLE_LM, batch=EXAMPLE_B, steps=steps, loss=loss_v,
        record_kind=rec.kind, flops_a_step=rec.flops,
        product_flops_a_step=rec.product_flops, closed_form=closed,
        bytes_a_step=rec.bytes_accessed,
        transcendentals_a_step=rec.transcendentals,
        goodput_frac=st['goodput_frac'], step_mfu=st['step_mfu'],
        hbm_bw_util_frac=st['hbm_bw_util_frac'],
        productive_s=st['productive_s'], window_s=st['window_s'],
        event_device_s=ev[0].elapsed_time(ev[1]) / 1e3, wall_s=wall_s,
        goodput_steps=st['by_kind'].get('fused', {}).get('steps'),
        profiler=dict(steps=OBS_PROFILED, wall_ms=prof_wall_ms,
                      device_ms=prof_dev_ms,
                      busy_share=prof_dev_ms / prof_wall_ms),
        program_peak_bytes=gauges.get(peak_key),
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        launches=counts, card=smi)
    failures = []
    if rec.product_flops != closed:
        failures.append('counted product flops %r, closed form %r'
                        % (rec.product_flops, closed))
    for k in ('step_mfu', 'hbm_bw_util_frac'):
        if out[k] is None or not 0 < out[k] <= 1.0:
            failures.append('%s %r' % (k, out[k]))
    if out['goodput_steps'] != steps:
        failures.append('goodput counted %r fused steps of %d'
                        % (out['goodput_steps'], steps))
    if not np.isfinite(loss_v):
        failures.append('loss %r' % loss_v)
    if out['program_peak_bytes'] is None:
        failures.append('no %s gauge' % peak_key)
    want = {k: steps * v for k, v in per.items()}
    if counts != want:
        failures.append('%d fused steps launched %s, not %s'
                        % (steps, counts, want))
    del scope
    exe.close()
    return out, counts, failures


def run_observability(torch, kt, smi):
    """Phase 29 (module docstring). Returns {path: launch counts}."""
    from paddle_tpu_torch import goodput, monitor, trace
    # a snapshot first: it exports the records the earlier phases left
    # uncounted, whose gauges would otherwise fill each metric's series
    # cap at the phase's first read
    monitor.snapshot()
    goodput.reset()
    monitor.reset()
    trace.reset()
    t0 = time.perf_counter()
    engine, engine_counts, failures = obs_engine(torch, kt, smi)
    torch.cuda.empty_cache()
    train, train_counts, train_failures = obs_train(torch, kt, smi)
    torch.cuda.empty_cache()
    emit(dict(phase='observability', card=smi, engine=engine, train=train,
              seconds=time.perf_counter() - t0))
    failures += train_failures
    if failures:
        raise AssertionError('observability: %s' % '; '.join(failures))
    return {'observability_engine': engine_counts,
            'observability_train': train_counts}


# ---------------------------------------------------------------------------
# phase 30: training health and fault tolerance


def health_program(fluid, cfg, seed=HEALTH_SEED):
    """(main, startup, lr, loss) of examples/train_lm.py's program for
    ``cfg`` (`example_program`) with a float [1] feed ``POISON`` added to
    its loss by an ``elementwise_add``: 0 on a good step, NaN on a
    poisoned one (its gradient does not depend on the feed, so the
    poisoned step's update is finite and only the loss is not). Seeded:
    two builds draw the same dropout masks."""
    from paddle_tpu_torch.contrib import mixed_precision as mp
    from paddle_tpu_torch.models.transformer import build_lm
    main_p, startup = fluid.Program(), fluid.Program()
    main_p.random_seed = startup.random_seed = seed
    with fluid.program_guard(main_p, startup), fluid.unique_name.guard():
        _, _, _, avg_loss = build_lm(cfg)
        poison = fluid.layers.data(name=POISON, shape=[1], dtype='float32',
                                   append_batch_size=False)
        loss = fluid.layers.elementwise_add(avg_loss, poison)
        lr = fluid.layers.learning_rate_scheduler.noam_decay(
            cfg.d_model, EXAMPLE_WARMUP)
        mp.decorate(fluid.optimizer.Adam(learning_rate=lr)).minimize(loss)
    return main_p, startup, lr, loss


def health_feed(batch, value=0.0):
    return dict(batch, **{POISON: np.full((1,), value, np.float32)})


def nonfinite_names(err):
    """The variables a ``FLAGS_check_nan_inf`` error names."""
    m = re.search(r'NaN/Inf detected in (\[.*?\]) after', str(err))
    if m is None:
        raise AssertionError('not a FLAGS_check_nan_inf error: %s' % err)
    return sorted(re.findall(r"'([^']+)'", m.group(1)))


def health_trajectory(torch, kt, fluid, cfg, init, batches, per_step,
                      guarded):
    """HEALTH_GOOD_STEPS good ``Executor.run`` steps of `health_program`
    from ``init`` over the cycled ``batches``, each launching exactly
    ``per_step``; ``guarded``: through ``TrainingGuard(health='preempt')``
    with one poisoned step before good step HEALTH_POISON_AT (its
    launches, the replay's included, recorded, not held). Returns
    (summary, losses, state arrays after the last step, launch counts of
    the good steps)."""
    from paddle_tpu_torch import resilience
    from paddle_tpu_torch.io import scope_from_numpy
    exe = fluid.Executor()
    main, _, _, loss = health_program(fluid, cfg)
    scope = scope_from_numpy(init, device=exe.device)
    guard = resilience.TrainingGuard(
        exe, main, loss_name=loss.name, scope=scope, max_bad_steps=2,
        health='preempt') if guarded else None
    out = dict(guarded=guarded)

    def step(feed):
        def run():
            if guard is not None:
                got = guard.step(feed=feed, fetch_list=[loss],
                                 return_numpy=False)
                if guard.last_step_skipped and feed[POISON][0] == 0:
                    raise AssertionError('the guard skipped a good step: '
                                         '%s' % guard.stats())
                return got[0]
            return exe.run(main, feed=feed, fetch_list=[loss], scope=scope,
                           return_numpy=False)[0]
        return run

    losses, ms, counts = [], [], dict.fromkeys(kt.KERNELS, 0)
    for i in range(HEALTH_GOOD_STEPS):
        if guarded and i == HEALTH_POISON_AT:
            before = state_arrays(scope)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            k0 = kt.launch_counts()
            t = time.perf_counter()
            guard.step(feed=health_feed(batches[i % len(batches)],
                                        float('nan')), fetch_list=[loss])
            torch.cuda.synchronize()
            k1 = kt.launch_counts()
            after = state_arrays(scope)
            out['poisoned'] = dict(
                skipped=guard.last_step_skipped, ms=(time.perf_counter() -
                                                     t) * 1e3,
                launches={k: k1[k] - k0[k] for k in k1 if k1[k] != k0[k]},
                peak_over_base_bytes=torch.cuda.max_memory_allocated() -
                base,
                localization=guard.last_localization and {
                    k: guard.last_localization[k]
                    for k in ('op_index', 'op_type', 'bad_outputs')},
                state_bitwise=sorted(before) == sorted(after) and all(
                    np.array_equal(before[k], after[k]) for k in before),
                rng_run_counter=main._rng_run_counter)
            del before, after
        torch.cuda.synchronize()
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        k0 = kt.launch_counts()
        t = time.perf_counter()
        losses += run_counted(kt, [step(health_feed(
            batches[i % len(batches)]))], per_step,
            'training_health %s step %d' % (
                'guarded' if guarded else 'unguarded', i))
        ms.append((time.perf_counter() - t) * 1e3)
        k1 = kt.launch_counts()
        for k in counts:
            counts[k] += k1[k] - k0[k]
        if i == 1:
            out['peak_over_base_bytes'] = \
                torch.cuda.max_memory_allocated() - base
    out.update(step_ms=ms, median_step_ms=float(np.median(ms[1:])),
               rng_run_counter=main._rng_run_counter)
    if guard is not None:
        # the snapshot's cost: a copy of every written persistable
        ts = []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            guard._snapshot(scope)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t) * 1e3)
        out.update(snapshot_bytes=guard.snapshot_bytes,
                   snapshot_ms=float(np.median(ts)),
                   guard_stats={k: v for k, v in guard.stats().items()
                                if k != 'health'})
    state = state_arrays(scope)
    del scope, guard
    return out, losses, state, main, counts


def health_stats_direct(torch, fluid, exe, main, loss, scope, feed):
    """One step of the instrumented ``main`` fetching its stat vector with
    every tensor it reduces (the gradients, the parameters after the
    update, the pre-update copies, the tapped activations, the loss), and
    the vector against ``torch.linalg.vector_norm`` of those tensors:
    (summary, failures). The norms and ratios within HEALTH_STAT_TOL
    relative, the counts exact, every update ratio above 0."""
    from paddle_tpu_torch import health
    sch = main._health_schema
    params = sch['params']
    grads = [g for _, g in main._health_params]
    pres = [p + '@health_pre' for p in params]
    acts = sch['acts']
    got = exe.run(main, feed=feed, fetch_list=[health.FETCH_NAME, loss] +
                  grads + pres + acts + params, scope=scope,
                  return_numpy=False)
    vec = got[0].double().cpu().numpy()
    n = len(params)
    G = [t.float() for t in got[2:2 + n]]
    P0 = [t.float() for t in got[2 + n:2 + 2 * n]]
    A = [t.float() for t in got[2 + 2 * n:2 + 2 * n + len(acts)]]
    P = [t.float() for t in got[2 + 2 * n + len(acts):]]
    norm = torch.linalg.vector_norm
    want = [norm(g) for g in G]
    for p, p0 in zip(P, P0):
        pn = norm(p0)
        want.append(norm(p - p0) / (pn + 1e-12) if pn > 0 else pn * 0)
    want += [torch.sqrt(torch.mean(a * a)) for a in A]
    flat = torch.cat([g.reshape(-1) for g in G])
    want += [norm(flat), norm(torch.cat([p.reshape(-1) for p in P])),
             (~torch.isfinite(flat)).sum().float(),
             (flat.abs() > 1e3).sum().float(), got[1].float().mean()]
    want = torch.stack([w.reshape(()) for w in want]).double().cpu().numpy()
    kinds = [k for k, _ in sch['entries']]
    rel = np.abs(vec - want) / np.maximum(np.abs(want), 1e-30)
    failures = []
    if len(vec) != len(want):
        failures.append('%d stats, %d direct' % (len(vec), len(want)))
    else:
        for k, r, g, w in zip(sch['entries'], rel, vec, want):
            exact = k[0] in ('nonfinite', 'large')
            if (g != w) if exact else not r <= HEALTH_STAT_TOL:
                failures.append('%s: %r against %r' % (k, g, w))
    ratios = [v for (k, _), v in zip(sch['entries'], vec)
              if k == 'upd_ratio']
    if not all(r > 0 for r in ratios):
        failures.append('update ratios at 0: %s' % [
            lbl for (k, lbl), v in zip(sch['entries'], vec)
            if k == 'upd_ratio' and not v > 0])
    out = dict(entries=len(vec), params=n, acts=len(acts),
               max_rel_err={kind: float(max(r for k, r in zip(kinds, rel)
                                            if k == kind))
                            for kind in sorted(set(kinds))},
               update_ratio_min=float(min(ratios)),
               update_ratio_max=float(max(ratios)),
               grad_norm_global=float(vec[kinds.index('grad_norm_global')]))
    return out, failures


def health_hold(torch, kt, fluid, cfg, smi):
    """Phase 30 (e): the instrumented program at HEALTH_HOLD_LAYERS layers,
    dropout 0, B DH256_HOLD_B, HEALTH_HOLD_STEPS ``run()`` steps on the
    card and on the CPU Executor from one initialization: each step's stat
    vector held at phase 15b's AMP limits (each entry within 2e-2 of its
    kind's largest magnitude on the CPU, the loss 5e-3 relative, the
    counts exact)."""
    from paddle_tpu_torch import health
    from paddle_tpu_torch.io import scope_from_numpy
    hold_cfg = type(cfg)(**dict(EXAMPLE_LM, n_layer=HEALTH_HOLD_LAYERS,
                                dropout=0.0))
    main, startup, _, loss = health_program(fluid, hold_cfg)
    health.instrument(main, loss.name)
    kinds = [k for k, _ in main._health_schema['entries']]
    s0 = fluid.Scope()
    fluid.Executor().run(startup, scope=s0)
    init = state_arrays(s0)
    del s0
    feed = health_feed({k: v.cpu().numpy() for k, v in lm_feed(
        torch, hold_cfg, DH256_HOLD_B, 30, 'cpu').items()})
    runs = {}
    for side, place in (('card', None), ('cpu', fluid.CPUPlace())):
        exe = fluid.Executor(place)
        scope = scope_from_numpy(init, device=exe.device)
        runs[side] = [exe.run(main, feed=feed, fetch_list=[
            health.FETCH_NAME], scope=scope)[0].astype(np.float64)
            for _ in range(HEALTH_HOLD_STEPS)]
        del scope
    worst, failures = {}, []
    for s, (got, want) in enumerate(zip(runs['card'], runs['cpu'])):
        for kind in sorted(set(kinds)):
            idx = [i for i, k in enumerate(kinds) if k == kind]
            g, w = got[idx], want[idx]
            if kind in ('nonfinite', 'large'):
                err, lim = float(np.abs(g - w).max()), 0.0
            elif kind == 'loss':
                err, lim = float(abs(g[0] / w[0] - 1)), 5e-3
            else:
                err = float(np.abs(g - w).max() / max(np.abs(w).max(),
                                                      1e-30))
                lim = 2e-2
            worst[kind] = max(worst.get(kind, 0.0), err)
            if not err <= lim:
                failures.append('step %d %s: %.3g over %.3g'
                                % (s + 1, kind, err, lim))
    out = dict(phase='training_health_hold', card=smi,
               n_layer=HEALTH_HOLD_LAYERS, batch=DH256_HOLD_B,
               steps=HEALTH_HOLD_STEPS, entries=len(kinds), worst=worst)
    emit(out)
    return out, failures


def bound_check_cost(torch, fluid, cfg, init, batch):
    """Phase 30 (g): the example's step bound twice on copies of one
    state, once with FLAGS_check_nan_inf on (its check in the graph) and
    once off, their calls alternating HEALTH_BOUND_CALLS times, each
    call's wall ms (the loss read is its sync): the medians and their
    difference. Then the bound plan with the check names the poisoned
    batch's variables. Returns (summary, names the bound call gave)."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.io import scope_from_numpy
    exe = fluid.Executor()
    main, _, _, loss = health_program(fluid, cfg)
    feed = health_feed(batch)
    bound, ms = {}, {True: [], False: []}
    for on in (True, False):
        flags.set_flags('check_nan_inf', on)
        scope = scope_from_numpy(init, device=exe.device)
        bound[on] = exe.bind(main, feed, fetch_list=[loss], scope=scope)
        bound[on](feed)         # the first replay
    try:
        for _ in range(HEALTH_BOUND_CALLS):
            for on in (True, False):
                flags.set_flags('check_nan_inf', on)
                torch.cuda.synchronize()
                t = time.perf_counter()
                bound[on](feed)
                ms[on].append((time.perf_counter() - t) * 1e3)
        flags.set_flags('check_nan_inf', True)
        try:
            bound[True](health_feed(batch, float('nan')))
            names = None
        except RuntimeError as e:
            names = nonfinite_names(e)
    finally:
        flags.set_flags('check_nan_inf', False)
    out = dict(calls=HEALTH_BOUND_CALLS,
               on_ms=float(np.median(ms[True])),
               off_ms=float(np.median(ms[False])),
               checked=len(bound[True]._plan.nan_names),
               launches_on=sum(bound[True].launches.values()),
               launches_off=sum(bound[False].launches.values()))
    out['check_ms'] = out['on_ms'] - out['off_ms']
    del bound
    exe.close()
    return out, names


def run_training_health(torch, kt, smi):
    """Phase 30 (module docstring). Returns {path: launch counts}."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import flags, monitor, resilience
    from paddle_tpu_torch.io import scope_from_numpy
    from paddle_tpu_torch.models.transformer import LMConfig
    t0 = time.perf_counter()
    cfg = LMConfig(**EXAMPLE_LM)
    hold, failures = health_hold(torch, kt, fluid, cfg, smi)
    torch.cuda.empty_cache()
    main, startup, _, loss = health_program(fluid, cfg)
    exe = fluid.Executor()
    s0 = fluid.Scope()
    exe.run(startup, scope=s0)
    init = state_arrays(s0)
    del s0
    per = dict(program_step_launches(cfg, amp=True), fused_adam=0)
    rng = np.random.RandomState(0)
    batches = [{k: torch.from_numpy(rng.randint(
        0, cfg.vocab_size, (EXAMPLE_B, cfg.seq_len)).astype('int64')).to(
            exe.device) for k in ('tokens', 'labels')}
        for _ in range(EXAMPLE_K)]
    prev_loc = os.environ.get('PADDLE_NAN_LOCALIZE')
    os.environ['PADDLE_NAN_LOCALIZE'] = '1'
    flags.set_flags('check_nan_inf', True)
    try:
        # (a)-(c) the guarded run with its poisoned step, then the same
        # good steps unguarded (the check off: it changes no value)
        guarded, g_losses, g_state, gmain, counts = health_trajectory(
            torch, kt, fluid, cfg, init, batches, per, True)
        torch.cuda.empty_cache()
        flags.set_flags('check_nan_inf', False)
        plain, u_losses, u_state, _, _ = health_trajectory(
            torch, kt, fluid, cfg, init, batches, per, False)
        torch.cuda.empty_cache()
        differ = sorted(k for k in u_state
                        if k not in g_state or
                        not np.array_equal(g_state[k], u_state[k]))
        # (d) the stat vector against direct norms, a step on the
        # guarded run's final state
        scope = scope_from_numpy(g_state, device=exe.device)
        direct, more = health_stats_direct(
            torch, fluid, exe, gmain, gmain.global_block().var(loss.name),
            scope, health_feed(batches[0]))
        failures += more
        del scope, g_state, u_state
        torch.cuda.empty_cache()
        # (f) run() and run_fused over a window holding the poisoned
        # batch name the same variables
        flags.set_flags('check_nan_inf', True)
        os.environ['PADDLE_NAN_LOCALIZE'] = '0'
        names = {}
        for how in ('run', 'run_fused'):
            scope = scope_from_numpy(init, device=exe.device)
            feeds = [health_feed(batches[i], v) for i, v in
                     enumerate((0.0, float('nan'), 0.0))]
            try:
                if how == 'run':
                    for f in feeds:
                        exe.run(main, feed=f, fetch_list=[loss],
                                scope=scope)
                else:
                    exe.run_fused(main, feeds, fetch_list=[loss],
                                  scope=scope)
                names[how] = None
            except RuntimeError as e:
                names[how] = nonfinite_names(e)
            del scope
        exe.close()
        torch.cuda.empty_cache()
        flags.set_flags('check_nan_inf', False)
        # (g) the check's cost a bound step, and the bound call's names
        bound, names['bind'] = bound_check_cost(torch, fluid, cfg, init,
                                                batches[0])
        torch.cuda.empty_cache()
        # (h) the fault drill: two injected run faults, retried to success
        drill_main, _, _, drill_loss = health_program(fluid, cfg)
        scope = scope_from_numpy(init, device=exe.device)
        guard = resilience.TrainingGuard(exe, drill_main,
                                         loss_name=drill_loss.name,
                                         scope=scope)
        guard.step(feed=health_feed(batches[0]), fetch_list=[drill_loss])
        before = monitor.counters()
        with resilience.fault_spec('run:n=2'):
            got = guard.step(feed=health_feed(batches[1]),
                             fetch_list=[drill_loss])
        delta = monitor.counter_delta(before)
        drill = dict(loss=float(got[0].reshape(-1)[0]),
                     skipped=guard.last_step_skipped,
                     retry_attempts=delta.get(
                         'retry_attempt_total{site=run}', 0),
                     faults=delta.get('fault_injected_total{site=run}', 0),
                     giveups=delta.get('retry_giveup_total{site=run}', 0))
        del scope, guard
        exe.close()
        torch.cuda.empty_cache()
    finally:
        flags.set_flags('check_nan_inf', False)
        if prev_loc is None:
            os.environ.pop('PADDLE_NAN_LOCALIZE', None)
        else:
            os.environ['PADDLE_NAN_LOCALIZE'] = prev_loc
    poisoned = guarded['poisoned']
    out = dict(phase='training_health', card=smi, config=EXAMPLE_LM,
               batch=EXAMPLE_B, good_steps=HEALTH_GOOD_STEPS,
               poisoned_before=HEALTH_POISON_AT, guarded=guarded,
               unguarded=plain, trajectory_bitwise=not differ and
               g_losses == u_losses, differ=differ[:8],
               losses=g_losses, stats_direct=direct, hold=hold['worst'],
               nonfinite_names=names, bound_check=bound, fault_drill=drill,
               guarded_over_unguarded=guarded['median_step_ms'] /
               plain['median_step_ms'],
               health_extra_peak_bytes=guarded['peak_over_base_bytes'] -
               plain['peak_over_base_bytes'],
               launches_per_step=per, seconds=time.perf_counter() - t0)
    emit(out)
    loc = poisoned['localization'] or {}
    if not poisoned['skipped'] or not poisoned['state_bitwise']:
        failures.append('the poisoned step: %s' % poisoned)
    if loc.get('op_type') != 'elementwise_add' or loc.get('op_index') != [
            i for i, op in enumerate(main.global_block().ops)
            if op.type == 'elementwise_add' and POISON in op.input_arg_names
    ][0]:
        failures.append('localized to %s, not the poison add' % loc)
    if differ or g_losses != u_losses:
        failures.append('guarded and unguarded trajectories differ: losses '
                        '%s / %s, state %s' % (g_losses, u_losses,
                                               differ[:8]))
    if guarded['rng_run_counter'] != plain['rng_run_counter']:
        failures.append('run counters %d / %d'
                        % (guarded['rng_run_counter'],
                           plain['rng_run_counter']))
    if not all(np.isfinite(g_losses)):
        failures.append('non-finite good losses %s' % g_losses)
    want_names = [loss.name]
    if any(v != want_names for v in names.values()):
        failures.append('check_nan_inf names %s, want %s for each'
                        % (names, want_names))
    if drill['retry_attempts'] != 2 or drill['faults'] != 2 or \
            drill['giveups'] or drill['skipped'] or \
            not np.isfinite(drill['loss']):
        failures.append('fault drill %s' % drill)
    if failures:
        raise AssertionError('training_health: %s' % '; '.join(failures))
    return {'training_health': counts}


def main():
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device available', file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, 'paddle_tpu_torch')):
        print('chip_smoke: paddle_tpu_torch/ not found beside the script',
              file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    import torch.nn.functional as F
    from paddle_tpu_torch import native
    from paddle_tpu_torch.ops import attention_ops
    from paddle_tpu_torch.ops import kernel_tier as kt

    # full f32 products on both sides of every comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    emit(dict(phase='device', kind=kind, count=torch.cuda.device_count(),
              nvidia_smi=smi, torch=torch.__version__,
              cuda=torch.version.cuda))

    # every source starts compiling now; the longest ones (LATE_SOURCES,
    # first run by phase 13) finish in the background while phases 3-12
    # run (a first use of their libraries would wait for them)
    t0 = time.perf_counter()
    late = {}

    def build_late():
        try:
            late['built'] = native.build(LATE_SOURCES)
        except Exception as e:      # noqa: BLE001 — raised at the join
            late['error'] = e
    late_build = threading.Thread(target=build_late, daemon=True)
    late_build.start()
    built = native.build([n for n in native.SOURCES
                          if n not in LATE_SOURCES])
    ptxas = ptxas_report(built['log'])
    emit(dict(phase='build', seconds=time.perf_counter() - t0,
              built=built['built'], nvcc=native.nvcc_path(), ptxas=ptxas,
              building_on=list(LATE_SOURCES)))

    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.models.transformer import LMConfig, param_shapes

    kernels = check_kernels(torch, F, kt)
    engine, counts = run_engine(torch, kt, smi)
    by_path = {'engine': counts}
    emit(engine)
    del engine
    torch.cuda.empty_cache()
    # kernels that several paths run come back with a case at each path's
    # shape: other[name][path] is that case
    other = {}
    for name, res in check_kernels(torch, F, kt, rows=[PAGED_SLOTS],
                                   decode_only=True).items():
        kernels[name]['max_abs_err'] = max(kernels[name]['max_abs_err'],
                                           res['max_abs_err'])
        other.setdefault(name, {})['engine_paged'] = res['cases']
    paged, by_path['engine_paged'] = run_engine_paged(torch, kt, smi)
    emit(paged)
    del paged
    torch.cuda.empty_cache()
    # phase 4c: the verify step's rows (the drafter's 16 are phase 4b's)
    for name, res in check_kernels(torch, F, kt,
                                   rows=[PAGED_SLOTS * (SPEC_K + 1)],
                                   decode_only=True).items():
        kernels[name]['max_abs_err'] = max(kernels[name]['max_abs_err'],
                                           res['max_abs_err'])
        other.setdefault(name, {})['engine_spec'] = res['cases']
    spec, by_path['engine_spec'] = run_engine_spec(torch, kt, smi)
    emit(spec)
    del spec
    torch.cuda.empty_cache()

    def merge(path, results):
        for name, res in results.items():
            if name in kernels:
                kernels[name]['max_abs_err'] = max(
                    kernels[name]['max_abs_err'], res['max_abs_err'])
                other.setdefault(name, {})[path] = res['cases']
            else:
                kernels[name] = res

    lm = LMConfig()
    merge('train', check_train_kernels(
        torch, F, 'train_kernel', lm, param_shapes(lm).values(),
        TRAIN_B * lm.seq_len, [(TRAIN_B * lm.seq_len, lm.vocab_size)]))
    unfused_card = compare_train_step_with_cpu(torch)
    train, by_path['train'] = run_training(torch, kt, 'train', lm,
                                           TRAIN_KERNELS)
    emit(train)

    flash = check_flash_kernels(torch, F, ptxas=ptxas)
    # each has one case at the LM's training shape, one at BERT's and one
    # at lm_dh256's; the forward has its prefill cases already, the
    # backward kernels' first path is the LM's training step
    for name in FLASH_KERNELS:
        lm_case, bert_case, dh256_case = flash[name]['cases']
        other[name] = {'bert': [bert_case], 'lm_dh256': [dh256_case]}
        if name in kernels:
            kernels[name]['max_abs_err'] = max(kernels[name]['max_abs_err'],
                                               flash[name]['max_abs_err'])
            other[name]['train_flash'] = [lm_case]
        else:
            kernels[name] = flash[name]
    flash_card = compare_train_step_with_cpu(torch, flash=True,
                                             unfused_card=unfused_card)
    del unfused_card
    train_flash, by_path['train_flash'] = run_training(
        torch, kt, 'train_flash', LMConfig(attn_dropout=0.0),
        FLASH_TRAIN_KERNELS,
        note="the bench's flagship row with amp=False: float32 (phase 15 "
             "runs its amp=True)")
    train_flash['unfused_step_ms'] = train['step_ms']
    train_flash['unfused_tokens_per_s'] = train['tokens_per_s']
    train_flash['unfused_peak_mem_bytes'] = train['peak_mem_bytes']
    emit(train_flash)
    f32_flash_step = {k: train_flash[k] for k in (
        'batch', 'step_ms', 'tokens_per_s', 'peak_mem_bytes')}
    f32_flash_step['device_ms'] = train_flash['step_profile'][
        'device_ms_per_step']
    del train, train_flash
    torch.cuda.empty_cache()
    program, program_paths = run_program_train(torch, kt, smi,
                                               f32_flash_step)
    by_path.update(program_paths)
    emit(program)
    del program
    torch.cuda.empty_cache()

    bc = bert.BertConfig()
    merge('bert', check_train_kernels(
        torch, F, 'bert_kernel', bc, bert.param_shapes(bc).values(),
        BERT_TRAIN_B * bc.seq_len,
        [(BERT_TRAIN_B * bc.max_predictions, bc.vocab_size),
         (BERT_TRAIN_B, 2)], ffn_infer_rows=[BERT_INFER_B * bc.seq_len]))
    bert_summary, by_path['bert'] = run_bert(torch, kt)
    emit(bert_summary)
    f32_infer_ms = bert_summary['infer']['forward_ms']
    del bert_summary
    torch.cuda.empty_cache()

    # bf16 AMP: the bf16 flash kernels, then the AMP training steps
    t = time.perf_counter()
    late_build.join()
    if 'error' in late:
        raise late['error']
    late_ptxas = ptxas_report(late['built']['log'])
    ptxas.update(late_ptxas)
    emit(dict(phase='build_late', seconds=late['built']['seconds'],
              waited_s=time.perf_counter() - t, built=late['built']['built'],
              ptxas=late_ptxas))
    amp_flash = check_flash_kernels(torch, F, torch.bfloat16, ptxas)
    for name in AMP_FLASH_KERNELS:
        lm_case, bert_case, long_case, dh256_case = amp_flash[name]['cases']
        other[name] = {'bert_amp': [bert_case],
                       'program_seq8k': [long_case],
                       'lm_dh256': [dh256_case]}
        kernels[name] = amp_flash[name]
    emit(check_head_widths(torch))
    kernels.update(check_wide_flash_kernels(torch, F, ptxas))
    by_path.update(run_flash_wide(torch, kt, smi))
    compare_train_step_with_cpu(torch, flash=True, amp=True,
                                f32_card=flash_card)
    del flash_card
    train_amp, by_path['train_amp'] = run_training(
        torch, kt, 'train_amp', LMConfig(attn_dropout=0.0),
        AMP_TRAIN_KERNELS, amp=True, batch=AMP_TRAIN_B,
        idle=AMP_IDLE_KERNELS)
    emit(train_amp)
    torch.cuda.empty_cache()
    train_amp_b16, _ = run_training(
        torch, kt, 'train_amp_b16', LMConfig(attn_dropout=0.0),
        AMP_TRAIN_KERNELS, amp=True, batch=TRAIN_B, idle=AMP_IDLE_KERNELS,
        note='like for like with phase 10 (f32_* keys)')
    train_amp_b16.update({'f32_' + k: v for k, v in f32_flash_step.items()})
    emit(train_amp_b16)
    amp_ref = {AMP_TRAIN_B: train_amp, TRAIN_B: train_amp_b16}
    del train_amp, train_amp_b16
    torch.cuda.empty_cache()
    bert_amp, by_path['bert_amp'] = run_bert_amp(torch, kt, f32_infer_ms)
    emit(bert_amp)
    bench, flash_amp = bert_amp['bench_config'], bert_amp['train']
    bert_ref = dict(f32_infer_ms=f32_infer_ms, amp=dict(
        amp_bench_config=dict(step_ms=bench['step_ms'],
                              samples_per_s=bench['samples_per_s']),
        amp_flash=dict(step_ms=flash_amp['step_ms'],
                       samples_per_s=flash_amp['samples_per_s'],
                       peak_mem_bytes=flash_amp['peak_mem_bytes'],
                       device_ms=flash_amp['step_profile'][
                           'device_ms_per_step'])))
    del bert_amp
    torch.cuda.empty_cache()

    # the AMP program pass and BERT through the Executor; lm_large's
    # kernels first at its own shapes (d 1024, 166 M parameters)
    large = LMConfig(**LM_LARGE)
    merge('program_large', check_train_kernels(
        torch, F, 'program_large_kernel', large, param_shapes(large).values(),
        LM_LARGE_B * large.seq_len,
        [(LM_LARGE_B * large.seq_len, large.vocab_size)], ffn=False))
    program_amp, paths = run_program_amp(torch, kt, smi, amp_ref)
    by_path.update(paths)
    emit(program_amp)
    del program_amp, amp_ref
    torch.cuda.empty_cache()
    program_bert, paths = run_program_bert(torch, kt, smi, bert_ref)
    by_path.update(paths)
    emit(program_bert)
    del program_bert
    torch.cuda.empty_cache()
    by_path.update(run_inference(torch, kt, smi))
    by_path.update(run_image_training(torch, kt, smi))
    by_path.update(run_optimizer_checks(torch, kt, smi))
    merge('stacked_lstm', check_lstm_gather(torch, F))
    by_path.update(run_stacked_lstm(torch, kt, smi))
    merge('ctr', check_ctr_gather(torch, F))
    by_path.update(run_ctr(torch, kt, smi))
    by_path.update(run_lm_dh256(torch, kt, smi))
    run_optest_replay(torch, smi)
    # phase 26: the example's kernels at its B 64 (the bf16 flash kernels'
    # case at this shape is phase 13's LM case: B 64 x 8 heads, L 512)
    example = LMConfig(**EXAMPLE_LM)
    merge('train_lm_example', check_train_kernels(
        torch, F, 'train_lm_example_kernel', example,
        param_shapes(example).values(), EXAMPLE_B * example.seq_len,
        [(EXAMPLE_B * example.seq_len, example.vocab_size)], ffn=False))
    for name in AMP_FLASH_KERNELS:
        other[name]['train_lm_example'] = [kernels[name]['cases'][0]]
    by_path.update(run_train_lm_example(torch, kt, smi))
    torch.cuda.empty_cache()
    # phase 27: the machine_translation row's gather shapes, then the row
    merge('nmt', check_nmt_gather(torch, F))
    by_path.update(run_nmt(torch, kt, smi))
    torch.cuda.empty_cache()
    # phase 28: the decode engine's programs, bound
    by_path.update(run_decode_programs(torch, kt, smi))
    torch.cuda.empty_cache()
    # phase 29: the observability tier on the engine and the example's step
    by_path.update(run_observability(torch, kt, smi))
    torch.cuda.empty_cache()
    # phase 30: training health and fault tolerance on the example's step
    by_path.update(run_training_health(torch, kt, smi))

    # kernel: (source, TPU kernel it replaces, case key, case value)
    meta = {
        'embedding_gather': ('paddle_tpu_torch/csrc/embedding_gather.cu',
                             'paddle_tpu/ops/embedding_ops.py:83', 'n', SLOTS),
        'fused_ln_residual': ('paddle_tpu_torch/csrc/ln_residual.cu',
                              'paddle_tpu/ops/nn_ops.py:477', 'n', SLOTS),
        'flash_attention': ('paddle_tpu_torch/csrc/flash_attn_fwd.cu',
                            'paddle_tpu/ops/attention_ops.py:162', 'T',
                            BUCKETS[-1]),
        'fused_ffn': ('paddle_tpu_torch/csrc/ffn_gemm.cu',
                      'paddle_tpu/ops/ffn_ops.py:120', 'n', SLOTS),
        'softmax_ce_fwd': ('paddle_tpu_torch/csrc/softmax_ce.cu',
                           'paddle_tpu/ops/ce_ops.py:98', 'n', None),
        'softmax_ce_bwd': ('paddle_tpu_torch/csrc/softmax_ce.cu',
                           'paddle_tpu/ops/ce_ops.py:144', 'n', None),
        'fused_ln_residual_bwd': ('paddle_tpu_torch/csrc/ln_residual.cu',
                                  'paddle_tpu/ops/nn_ops.py:516', 'n', None),
        'fused_adam': ('paddle_tpu_torch/csrc/fused_adam.cu',
                       'paddle_tpu/ops/optimizer_ops.py:239', 'tensors',
                       None),
        'flash_attention_bwd_dq': ('paddle_tpu_torch/csrc/flash_attn_bwd.cu',
                                   'paddle_tpu/ops/attention_ops.py:307',
                                   'shape', 'lm_train'),
        'flash_attention_bwd_dkv': ('paddle_tpu_torch/csrc/flash_attn_bwd.cu',
                                    'paddle_tpu/ops/attention_ops.py:329',
                                    'shape', 'lm_train'),
        'flash_attention_bf16': ('paddle_tpu_torch/csrc/flash_attn_bf16_fwd.cu',
                                 'paddle_tpu/ops/attention_ops.py:162',
                                 'shape', 'lm_train'),
        'flash_attention_bf16_bwd_dq': (
            'paddle_tpu_torch/csrc/flash_attn_bf16_bwd.cu',
            'paddle_tpu/ops/attention_ops.py:307', 'shape', 'lm_train'),
        'flash_attention_bf16_bwd_dkv': (
            'paddle_tpu_torch/csrc/flash_attn_bf16_bwd.cu',
            'paddle_tpu/ops/attention_ops.py:329', 'shape', 'lm_train'),
        'flash_attention_wide': ('paddle_tpu_torch/csrc/flash_attn_wide.cu',
                                 'paddle_tpu/ops/attention_ops.py:162',
                                 'shape', 'flash_wide_f32'),
        'flash_attention_wide_bwd_dq': (
            'paddle_tpu_torch/csrc/flash_attn_wide.cu',
            'paddle_tpu/ops/attention_ops.py:307', 'shape', 'flash_wide_f32'),
        'flash_attention_wide_bwd_dkv': (
            'paddle_tpu_torch/csrc/flash_attn_wide.cu',
            'paddle_tpu/ops/attention_ops.py:329', 'shape', 'flash_wide_f32'),
    }
    line = []
    for name in kt.KERNELS:
        src, repl, key, at = meta[name]
        res = kernels[name]
        case = [c for c in res['cases'] if at is None or c[key] == at][0]
        launches = {path: c[name] for path, c in by_path.items()}
        line.append(dict(
            name=name, route='cuda', source=src, replaces=repl,
            launches=sum(launches.values()), launches_by_path=launches,
            max_abs_err=res['max_abs_err'],
            ms=case['ms'], plain_ms=case['plain_ms'],
            bound_ms=case['bound_ms'], bound_by=case['bound_by'],
            **({'bound_simt_ms': case['bound_simt_ms']}
               if 'bound_simt_ms' in case else {}),
            library_ms=case['library_ms'], eager_ms=case['eager_ms'],
            shape={key: case[key]},
            **({'head_widths': 'multiples of 128 above 256'}
               if name in WIDE_FLASH_KERNELS else
               {'head_widths': list(attention_ops._WIDTHS)}
               if name.startswith('flash') else {}),
            tolerance=res['tolerance'],
            checked=res.get('checked', 'max_abs_err'),
            **({'max_rel_err': res['max_rel_err']}
               if 'max_rel_err' in res else {})))
        if name in other:
            # a kernel several paths run: its cases at their shapes too
            line[-1]['other_cases'] = other[name]
        idle = [path for path, n in launches.items()
                if n <= 0 and name in PATH_KERNELS[path]]
        if idle:
            raise AssertionError('%s was never launched on the %s path'
                                 % (name, idle))
    emit(dict(phase='total', seconds=time.perf_counter() - t_start,
              card=smi))
    emit({'kernels': line})
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': kind,
                                 'count': torch.cuda.device_count()}})
    return 0


def eager_ab(trees, rounds=EAGER_AB_ROUNDS, steps=EAGER_AB_STEPS):
    """``python chip_smoke.py --eager-ab TREE [TREE ...]``: the
    machine_translation row's eager training step (phase 27's program at
    B NMT_B x L NMT_L) from each TREE's paddle_tpu_torch (a checkout, each
    building its own kernels), all loaded side by side in this process.
    Each round times ``steps`` steps of every tree, in the given order on
    even rounds and reversed on odd ones. Prints per tree the median and
    best ms a step and the Python function calls of one step
    (cProfile)."""
    import cProfile
    import importlib
    import importlib.util
    import pstats
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    runs = {}
    for i, root in enumerate(trees):
        alias = 'eager_ab%d' % i
        pkg = os.path.join(os.path.abspath(root), 'paddle_tpu_torch')
        spec = importlib.util.spec_from_file_location(
            alias, os.path.join(pkg, '__init__.py'),
            submodule_search_locations=[pkg])
        fluid = importlib.util.module_from_spec(spec)
        sys.modules[alias] = fluid
        spec.loader.exec_module(fluid)
        importlib.import_module(alias + '.native').build()
        s2s = importlib.import_module(alias + '.models.seq2seq')
        cfg = s2s.Seq2SeqConfig(beam_size=GEN_BEAM)
        main, startup = fluid.Program(), fluid.Program()
        startup.random_seed = 27
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            feeds, loss, _ = s2s.build_nmt_train(cfg)
            fluid.optimizer.Adam(learning_rate=1e-4).minimize(loss)
        exe, scope = fluid.Executor(), fluid.Scope()
        exe.run(startup, scope=scope)
        batch, = nmt_batches(np.random.RandomState(0), feeds, cfg.dict_size,
                             [NMT_L] * NMT_B, 1,
                             to=lambda a: torch.from_numpy(a).to(exe.device))

        def step(exe=exe, main=main, batch=batch, loss=loss, scope=scope):
            return exe.run(main, feed=batch, fetch_list=[loss], scope=scope,
                           return_numpy=False)[0]
        step()
        step()
        torch.cuda.synchronize()
        prof = cProfile.Profile()
        prof.enable()
        step()
        prof.disable()
        torch.cuda.synchronize()
        runs[root] = dict(step=step, calls=pstats.Stats(prof).total_calls,
                          ms=[])
    for r in range(rounds):
        for root in (trees if r % 2 == 0 else trees[::-1]):
            run = runs[root]
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(steps):
                out = run['step']()
            float(out.reshape(-1)[0])
            run['ms'].append((time.perf_counter() - t) * 1e3 / steps)
    emit(dict(phase='eager_ab', card=smi, rounds=rounds, steps=steps,
              trees={root: dict(median_ms=float(np.median(r['ms'])),
                                best_ms=min(r['ms']),
                                python_calls_a_step=r['calls'], ms=r['ms'])
                     for root, r in runs.items()}))
    return 0


if __name__ == '__main__':
    if sys.argv[1:2] == ['--eager-ab']:
        sys.exit(eager_ab(sys.argv[2:]))
    sys.exit(main())
