#!/usr/bin/env python3
"""Drive paddle_tpu_torch's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  — the card's name, plus ``nvidia-smi --query-gpu=name,power.limit
   --format=csv,noheader`` printed as it comes (a line of its own).
2. build   — nvcc builds every CUDA kernel of the port from csrc/ (all
   sources in parallel), with its seconds and, from ``-Xptxas -v``, each
   kernel's registers and spilled bytes (``ptxas``).
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
   padded, for which O, dQ, dK and dV must be exactly 0. O and LSE within
   1e-4 absolute (LSE on the rows that keep a key); each gradient within
   1e-4 of that tensor's largest magnitude; two calls of each kernel give
   the same bits. ``library_ms`` is ``F.scaled_dot_product_attention`` and
   its backward through autograd (one call that yields dQ, dK and dV
   together), timed only: the backward's device time from CUDA-graph
   replays like the kernels', and ``library_eager_ms`` its eager rate.
   ``bound_ms`` counts the visible (query, key) pairs of this run's mask:
   4 dh flops a pair forward, 6 dh for dQ, 8 dh for dK/dV.
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
   phase 8) and (c) ``lm_long_seq8k``'s (bench.py:1124-1129), BH 16 (B 2 x
   8 heads), L 8192, dh 64, causal. O, dQ, dK and dV within 1e-2 of each
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
   kernels at head widths 8, 48, 80 and 96 (the wrappers zero-pad them to
   16, 64, 128 and 128), B 4 x H 2, L 200, causal, a key-padding bias
   keeping 200, 173, 140 and 101 keys: within phases 8's and 13's
   tolerances of their plain versions at the true width, one launch each a
   call; a width of 160 raises.
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

``bound_ms`` is the least time the card could take: the larger of the
bytes (each input read once, each output written once) over 3.35 TB/s and
the operations' time, where matrix-product flops (the FFN's two products,
the flash kernels' Q·K^T, P·V and gradient products) count at 165 TFLOP/s
(495 TFLOP/s TF32 over the 3xTF32 split's three passes: f32 accuracy on the
tensor cores), the bf16 kernels' products at 989 TFLOP/s, and other flops
at the f32 CUDA-core peak of 67 TFLOP/s.
Those four kernels also get ``bound_simt_ms``, every flop at 67 TFLOP/s,
the rule of the tables before the tensor-core kernels.

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
                'program_bert_fused': AMP_BERT_UNFUSED_KERNELS}


def emit(obj):
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


def step_profile(torch, fn, steps=10, host=False):
    """Device time of ``steps`` eager calls of ``fn`` by torch.profiler:
    the wall time, the summed kernel time, the busy share, the kernels
    taking the most device time and the host ops that launched the most of
    it; with ``host`` also the host ops taking the most host time of their
    own (``top_host``). ``busy_share`` is None when the profiler recorded
    no device time (then it was not measured)."""
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
    length-prefixed name components (after any namespace) and its integer
    or bool template arguments; ``mangled`` itself when it does not
    parse."""
    pos, name = (3 if mangled.startswith('_ZN') else 2), None
    while True:
        m = re.compile(r'\d+').match(mangled, pos)
        if not m:
            break
        pos = m.end() + int(m.group())
        name = mangled[m.end():pos]
    if not name:
        return mangled
    args = re.compile(r'I((?:L\w\d+E)+)E').match(mangled, pos)
    if args:
        name += '<%s>' % ', '.join(re.findall(r'L\w(\d+)E', args.group(1)))
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
    cases = []
    gd = torch.Generator(device=dev).manual_seed(99)
    for n in rows:
        ids = torch.randint(0, V, (n,), generator=g).to(dev)
        got = embedding_ops.embedding_gather(w, ids)
        want = embedding_ops._gather_ref(w, ids)
        err = max_err(torch, [got], [want])
        nbytes = 2 * n * d * 4 + n * 8
        ms, plain, library = gather_times(torch, F, embedding_ops, w, n, gd,
                                          nbytes)
        cases.append(dict(**bound(nbytes, 0),
            n=n, max_abs_err=err, ms=ms, rotating_sets=rotation(nbytes),
            eager_ms=eager_ms(torch, lambda: embedding_ops.embedding_gather(
                w, ids)),
            plain_ms=plain, library_ms=library))
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
    lens = np.linspace(5, BUCKETS[-1], N_REQUESTS).astype(int)
    work = []
    for i, n in enumerate(lens):
        prompt = rs.randint(2, cfg.model.vocab_size, size=int(n))
        sampled = i % 2 == 1
        work.append((prompt, dict(temperature=0.8, top_k=50, top_p=0.9,
                                  sample_seed=1000 + i) if sampled else {}))

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
    t0 = time.perf_counter()
    with eng:
        reqs = [eng.submit(p, max_new_tokens=NEW_TOKENS, **kw)
                for p, kw in work]
        outs = [r.result(600) for r in reqs]
    wall = time.perf_counter() - t0
    counts = kt.launch_counts()
    stats = eng.stats()
    counters = dict(eng.counters)
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
    hits = counters['kv_prefix_hit_total{outcome=hit}']
    cows = counters['kv_block_cow_total']
    # a shared prompt's hit caches its 12 prefix blocks; a copy-on-write
    # prompt (the prefix alone) recomputes its last position
    saved = PAGED_PREFIX * (hits - cows) + (PAGED_PREFIX - 1) * cows
    if hits < 15 or cows < 4 or \
            counters['kv_prefix_tokens_saved_total'] != saved:
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
        t0 = time.perf_counter()
        with eng:
            reqs = [eng.submit(p, **dict(kw, **(
                sampled_tokens if kw else dict(max_new_tokens=NEW_TOKENS))))
                for p, kw in work]
            outs = [r.result(600) for r in reqs]
            held = dict(eng.stats()['blocks'])
        return dict(outs=outs, wall=time.perf_counter() - t0, held=held,
                    stats=eng.stats(), counters=dict(eng.counters))

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
    if not (fb['spec_fallback_total'] > 0 and
            fb['spec_stale_draft_rounds_total'] >= 1):
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


def check_train_kernels(torch, F, phase, cfg, shapes, n_rows, ce_shapes,
                        ffn_infer_rows=(), ffn=True):
    """Phases 5, 11 and 15b (d): the kernels a training step runs, but for
    flash attention, at one model's shapes: ``n_rows`` rows of
    ``cfg.d_model``, CE at each (rows, vocabulary) of ``ce_shapes``, Adam
    over the parameter ``shapes``, and the FFN (unless ``ffn`` is false: an
    AMP step stands it down) also at each of ``ffn_infer_rows`` as
    inference calls it (no mask, no pre1). Returns {kernel name: summary
    dict} as check_kernels does."""
    from paddle_tpu_torch.ops import (ce_ops, embedding_ops, nn_ops,
                                      optimizer_ops)
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
    cases = []
    for rows in [V] + ([cfg.type_vocab_size]
                       if hasattr(cfg, 'type_vocab_size') else []):
        w = randn(rows, D, scale=0.02)
        ids = torch.randint(0, rows, (N,), generator=g, device=dev)
        err = max_err(torch, [embedding_ops.embedding_gather(w, ids)],
                      [embedding_ops._gather_ref(w, ids)])
        nbytes = (N + min(N, rows)) * D * 4 + N * 8
        ms, plain, library = gather_times(
            torch, F, embedding_ops, w, N,
            torch.Generator(device=dev).manual_seed(98), nbytes)
        cases.append(dict(
            n=N, table_rows=rows, max_abs_err=err, ms=ms, plain_ms=plain,
            library_ms=library, rotating_sets=rotation(nbytes),
            eager_ms=eager_ms(torch, lambda: embedding_ops.embedding_gather(
                w, ids), iters=10, warmup=2), **bound(nbytes, 0)))
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
    del w, x, r
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
    phase 13 also ``lm_long_seq8k``'s (B 2 x 8 heads, L 8192, causal)."""
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


def check_flash_kernels(torch, F, dtype=None, ptxas=None):
    """Phases 8 and 13: the three flash kernels at the LM training shape and
    at BERT's (with the key-padding bias), on float32 operands (phase 8) or
    on bf16 ones (phase 13, ``dtype`` bf16: the bf16 kernels at the AMP
    step's B 64; each kernel's cases also name their plan and, from
    ``ptxas`` (``ptxas_report`` of the build), the registers and spilled
    bytes of the instantiation that plan launches; no instantiation of the
    forward, the dQ or the dK/dV kernel may spill). Returns
    {kernel name: summary}."""
    from paddle_tpu_torch.ops import attention_ops as A
    dtype = dtype or torch.float32
    low = dtype == torch.bfloat16
    fwd_ptxas = (ptxas or {}).get('flash_attn_bf16_fwd', {})
    bwd_ptxas = (ptxas or {}).get('flash_attn_bf16_bwd', {})
    dq_ptxas, dkv_ptxas = ({k: r for k, r in bwd_ptxas.items()
                            if k.startswith(name)}
                           for name in ('flash_bwd_dq_bf16',
                                        'flash_bwd_dkv_bf16'))
    if low:
        for what, rep in (('forward', fwd_ptxas), ('dQ', dq_ptxas),
                          ('dK/dV', dkv_ptxas)):
            spilled = {k: r for k, r in rep.items() if r[1] or r[2]}
            if spilled:
                raise AssertionError('the bf16 %s spills: %s'
                                     % (what, spilled))
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

        def case(fn, plain, library, nbytes, flops, **errs):
            # every flop counted here is a matrix product's
            products = dict(bf16_flops=flops) if low else \
                dict(product_flops=flops)
            return dict(common, ms=cuda_ms(torch, fn, calls=10, replays=5),
                        eager_ms=eager_ms(torch, fn, iters=10, warmup=2),
                        plain_ms=cuda_ms(torch, plain, calls=5, replays=5),
                        **library, **bound(nbytes, 0, **products), **errs)

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
        out[names[0]]['cases'].append(case(
            lambda: A._flash_fwd(q, k, v, *args),
            lambda: A._attention_ref(q, k, v, *args),
            fwd_library,
            4 * mat + row + extra, 4 * dh * sh['pairs'],
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
            **dq_extra,
            max_abs_err=float((dq.float() - dq_ref.float()).abs().max()),
            max_rel_err=rel(dq, dq_ref),
            largest_magnitude=dict(dq=float(dq_ref.float().abs().max())),
            deterministic=same_bits(torch, lambda: A._flash_bwd_dq(
                q, k, v, do, lse, delta, *args))))
        out[names[2]]['cases'].append(case(
            lambda: A._flash_bwd_dkv(q, k, v, do, lse, delta, *args),
            lambda: A._bwd_dkv_ref(q, k, v, do, lse, delta, *args),
            lib_bwd, 6 * mat + 2 * row + extra, 8 * dh * sh['pairs'],
            **dkv_extra,
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
    at head widths between their instantiations (8, 48, 80, 96), which the
    wrappers zero-pad to the next one (16, 64, 128, 128), on a small
    causal shape (B 4, H 2, L 200) with a key-padding bias cutting the
    elements to 200, 173, 140 and 101 keys: each held to its plain version
    at the true width within phase 8's and 13's tolerances (float32: O and
    LSE 1e-4 absolute, each gradient 1e-4 of its largest magnitude; bf16:
    O, dQ, dK and dV 1e-2 of theirs, LSE 1e-5), each launched once a
    call; a width above 128 raises."""
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
        for dh in (8, 48, 80, 96):
            q, k, v, do = (torch.randn((B * H, L, dh), generator=g,
                                       device=dev).to(dtype)
                           for _ in range(4))
            args = (dh ** -0.5, True, bias, H)
            before = kt.launch_counts()
            o, lse = A._flash_fwd(q, k, v, *args)
            dq, dk, dv = A._flash_bwd(q, k, v, o, lse, do, *args)
            torch.cuda.synchronize()
            after = kt.launch_counts()
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
                        launches=[after[n] - before[n] for n in names])
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
    q = torch.randn((2, 8, 160), device=dev)
    try:
        A._flash_fwd(q, q, q, 160 ** -0.5, True)
    except ValueError:
        pass
    else:
        raise AssertionError('a head width of 160 did not raise')
    return dict(phase='flash_head_widths', shape=dict(B=B, H=H, L=L),
                causal=True, keys_kept=[200, 173, 140, 101], cases=cases)


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
        out.update(dict.fromkeys(AMP_FLASH_KERNELS if amp else FLASH_KERNELS,
                                 n))
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
    stacked on the card, one first call of ``steps`` steps (its eager first
    step and the capture), then ``rounds`` calls of ``steps`` steps, each
    timed with its own sync (a read of the loss); the best round over its
    steps. The bench's 120 steps a call and 2-3 rounds are cut to
    ``steps`` and ``rounds`` to keep the script's run short. Every replay
    of the timed rounds launches exactly ``per_step`` and nothing is
    captured after the first call. Returns (summary, counts of the timed
    rounds)."""
    stacked = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
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
    return dict(k_batches=len(batches), steps_per_call=steps,
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

    t0 = time.perf_counter()
    built = native.build()
    ptxas = ptxas_report(built['log'])
    emit(dict(phase='build', seconds=time.perf_counter() - t0,
              built=built['built'], nvcc=native.nvcc_path(), ptxas=ptxas))

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

    flash = check_flash_kernels(torch, F)
    # each has one case at the LM's training shape and one at BERT's; the
    # forward has its prefill cases already, the backward kernels' first
    # path is the LM's training step
    for name in FLASH_KERNELS:
        lm_case, bert_case = flash[name]['cases']
        other[name] = {'bert': [bert_case]}
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
    amp_flash = check_flash_kernels(torch, F, torch.bfloat16, ptxas)
    for name in AMP_FLASH_KERNELS:
        lm_case, bert_case, long_case = amp_flash[name]['cases']
        other[name] = {'bert_amp': [bert_case],
                       'program_seq8k': [long_case]}
        kernels[name] = amp_flash[name]
    emit(check_head_widths(torch))
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


if __name__ == '__main__':
    sys.exit(main())
