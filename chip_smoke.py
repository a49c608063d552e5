#!/usr/bin/env python3
"""Drive paddle_tpu_torch's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  — the card's name, plus ``nvidia-smi --query-gpu=name,power.limit
   --format=csv,noheader`` printed as it comes (a line of its own).
2. build   — nvcc builds every CUDA kernel of the port from csrc/ (all
   sources in parallel), with its seconds.
3. kernel  — each kernel's wrapper on the card at the shapes the decode
   engine gives it, held against its plain PyTorch version on the same
   inputs (max abs error within a stated tolerance). ``ms``, ``plain_ms``
   and ``library_ms`` (one PyTorch library call computing the same function,
   timed only: the port never calls it) are device times, from CUDA events
   around replays of a CUDA graph of 20 calls; ``eager_ms`` is the
   wrapper's back-to-back eager rate, host overhead included.
4. engine  — the full-width flagship LM (V 32000, d 512, 8 heads, 6 layers,
   d_ff 2048; random weights from a seed) behind GenerateEngine: warmup,
   16 concurrent requests (prompts of 5..256 tokens, 32 new tokens, half
   greedy and half sampled with pinned seeds), every request equal to its
   own generate_once, every kernel's launch count risen in this phase, the
   card's logits within tolerance of the plain-PyTorch path on the CPU, and
   tokens/s, prefill ms per bucket, decode-step ms beside the step's memory
   floor, and a torch.profiler breakdown of a decode step and a prefill
   (device busy share, the kernels taking the most device time).

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
   dropout 0.1, so attention is the unfused branch) and ``Adam(1e-4,
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
   1e-4 of that tensor's largest magnitude. ``library_ms`` is
   ``F.scaled_dot_product_attention`` and its backward through autograd
   (one call that yields dQ, dK and dV together; timed by CUDA events
   around eager calls), timed only. ``bound_ms`` counts the visible (query,
   key) pairs of this run's mask: 4 dh flops a pair forward, 6 dh for dQ,
   8 dh for dK/dV.
9. flash_train_vs_cpu — phase 6 with flash attention on: the card against
   the CPU, and on the card flash against the unfused branch of phase 6,
   same limits.
10. train_flash — phase 7 in the configuration the repo's bench trains
   (attention dropout 0, flash attention on; its ``amp=True`` is not
   ported): all ten kernels of that path launched (the seven of phase 7 and
   the flash forward, dQ and dK/dV), step ms and tokens/s beside phase 7's.
11. bert_kernel — the kernels of phases 3 and 5 at BERT-base's shapes (rows
   of D 768, the FFN at 768 -> 3072 -> 768, CE at V 30522 and at V 2,
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
   trains (dropout 0.1, ``Adam(1e-4, fuse=True)``, one fixed batch): the
   loss finite and fallen, all ten kernels launched, step ms, samples/s,
   peak memory and a profile of one step.

Then one line ``{"kernels": [...]}`` (per kernel: route, source, the TPU
kernel it replaces, launches on each path, max abs error, ms, plain_ms,
bound_ms and what bounds it, library_ms, at the shape of the first path
that runs it, with its cases at the other paths' shapes beside them), and
last ``{"ok": true, "device": {...}}``. Any
failure raises: the script exits non-zero and prints no last line. Without
a CUDA card, or without the rest of the repository beside it, it exits
non-zero at once.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and f32
# throughput outside the tensor cores — the kernels here are f32 SIMT
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

SLOTS = 8
MAX_LEN = 512
BUCKETS = (64, 128, 256)
NEW_TOKENS = 32
N_REQUESTS = 16

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
PATH_KERNELS = {'engine': ENGINE_KERNELS, 'train': TRAIN_KERNELS,
                'train_flash': FLASH_TRAIN_KERNELS,
                'bert': FLASH_TRAIN_KERNELS}


def emit(obj):
    print(json.dumps(obj), flush=True)


def bound(nbytes, flops):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    f32 operations over the f32 peak."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


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


def step_profile(torch, fn, steps=10):
    """Device time of ``steps`` eager calls of ``fn`` by torch.profiler:
    the wall time, the summed kernel time, the busy share, and the kernels
    taking the most device time. ``busy_share`` is None when the profiler
    recorded no device time (then it was not measured)."""
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
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    return dict(
        steps=steps, wall_ms_per_step=wall_ms / steps,
        device_ms_per_step=dev_ms / steps,
        busy_share=dev_ms / wall_ms if dev_ms > 0 else None,
        launches_per_step=sum(e.count for e in kernels) / steps,
        top=[dict(name=e.key[:60], count=e.count,
                  ms_per_step=e.self_device_time_total / 1e3 / steps)
             for e in top])


def max_err(torch, got, want):
    return max(float((g.float() - w.float()).abs().max())
               for g, w in zip(got, want))


def check_kernels(torch, F, kt):
    """Phase 3. Returns {kernel name: summary dict} with per-shape cases."""
    from paddle_tpu_torch.ops import (attention_ops, embedding_ops,
                                      ffn_ops, nn_ops)
    dev = torch.device('cuda', 0)
    g = torch.Generator(device='cpu').manual_seed(1234)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    d, d_ff, V, H = 512, 2048, 32000, 8
    dh = d // H
    rows = list(BUCKETS) + [SLOTS]
    out = {}

    # embedding gather: exact (a copy); ids in range, plus a clamp probe
    w = randn(V, d, scale=0.02)
    cases = []
    for n in rows:
        ids = torch.randint(0, V, (n,), generator=g).to(dev)
        got = embedding_ops.embedding_gather(w, ids)
        want = embedding_ops._gather_ref(w, ids)
        err = max_err(torch, [got], [want])
        nbytes = 2 * n * d * 4 + n * 8
        b_ms, b_by = bound(nbytes, 0)
        cases.append(dict(
            n=n, max_abs_err=err,
            ms=cuda_ms(torch, lambda: embedding_ops.embedding_gather(w, ids)),
            eager_ms=eager_ms(torch, lambda: embedding_ops.embedding_gather(
                w, ids)),
            plain_ms=cuda_ms(torch, lambda: embedding_ops._gather_ref(w, ids)),
            library_ms=cuda_ms(torch, lambda: F.embedding(ids, w)),
            bound_ms=b_ms, bound_by=b_by))
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
        b_ms, b_by = bound(nbytes, 9 * n * d)
        cases.append(dict(
            n=n, max_abs_err=err,
            ms=cuda_ms(torch, lambda: nn_ops.fused_ln_residual(
                x, r, sc, bi, 1e-5)),
            eager_ms=eager_ms(torch, lambda: nn_ops.fused_ln_residual(
                x, r, sc, bi, 1e-5)),
            plain_ms=cuda_ms(torch, lambda: nn_ops._ln_res_ref(
                x, r, sc, bi, 1e-5)),
            library_ms=cuda_ms(torch, lambda: F.layer_norm(
                x + r, (d,), sc, bi, 1e-5)),
            bound_ms=b_ms, bound_by=b_by))
    out['fused_ln_residual'] = dict(tolerance=1e-4, cases=cases)

    # flash attention, causal, B 1, H 8, dh 64: online softmax vs the
    # plain two-pass softmax -> 1e-4 absolute on O and LSE
    cases = []
    for T in BUCKETS:
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
        b_ms, b_by = bound(nbytes, flops)
        q3, k3, v3 = (t.reshape(H, T, dh) for t in (q, k, v))
        cases.append(dict(
            T=T, max_abs_err=err,
            ms=cuda_ms(torch, lambda: attention_ops.flash_attention(
                q, k, v, causal=True)),
            eager_ms=eager_ms(torch, lambda: attention_ops.flash_attention(
                q, k, v, causal=True)),
            plain_ms=cuda_ms(torch, lambda: attention_ops._attention_ref(
                q3, k3, v3, dh ** -0.5, True)),
            library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True)),
            bound_ms=b_ms, bound_by=b_by))
    out['flash_attention'] = dict(tolerance=1e-4, cases=cases)

    # FFN tail: two f32 GEMMs (K = 512 and 2048) in another summation
    # order than cuBLAS, plus erfc -> 1e-4 absolute on y and pre1
    w1, b1 = randn(d, d_ff, scale=0.02), randn(d_ff, scale=0.02)
    w2, b2 = randn(d_ff, d, scale=0.02), randn(d, scale=0.02)
    cases = []
    for n in rows:
        x = randn(n, d)
        got = ffn_ops.fused_ffn_core(x, w1, b1, w2, b2, want_pre1=True)
        want = ffn_ops._ffn_ref(x, w1, b1, w2, b2)
        err = max_err(torch, got, want)
        nbytes = (n * d + d * d_ff + d_ff + d_ff * d + d + n * d) * 4
        flops = 2 * n * d * d_ff * 2 + 8 * n * d_ff
        b_ms, b_by = bound(nbytes, flops)
        cases.append(dict(
            n=n, max_abs_err=err,
            ms=cuda_ms(torch, lambda: ffn_ops.fused_ffn_core(
                x, w1, b1, w2, b2)),
            eager_ms=eager_ms(torch, lambda: ffn_ops.fused_ffn_core(
                x, w1, b1, w2, b2)),
            plain_ms=cuda_ms(torch, lambda: ffn_ops._ffn_ref(
                x, w1, b1, w2, b2)),
            library_ms=cuda_ms(torch, lambda: F.gelu(x @ w1 + b1) @ w2 + b2),
            bound_ms=b_ms, bound_by=b_by))
    out['fused_ffn'] = dict(tolerance=1e-4, cases=cases)

    for name, res in out.items():
        worst = max(c['max_abs_err'] for c in res['cases'])
        res['max_abs_err'] = max(worst, res.get('clamp_err', 0.0))
        for c in res['cases']:
            emit(dict(phase='kernel', name=name, tolerance=res['tolerance'],
                      **c))
        if not res['max_abs_err'] <= res['tolerance']:
            raise AssertionError('%s disagrees with its plain version: max '
                                 'abs err %g > %g' % (name, res['max_abs_err'],
                                                      res['tolerance']))
    return out


def run_engine(torch, kt):
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

    kt.reset_counts()
    eng = GenerateEngine(cfg)                       # cuda:0
    warm = eng.warmup()
    t0 = time.perf_counter()
    with eng:
        reqs = [eng.submit(p, max_new_tokens=NEW_TOKENS, **kw)
                for p, kw in work]
        outs = [r.result(600) for r in reqs]
    wall = time.perf_counter() - t0
    refs = [eng.generate_once(p, max_new_tokens=NEW_TOKENS, **kw)
            for p, kw in work]
    counts = kt.launch_counts()

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

    # timings of the two shapes the engine runs (host clock to a sync)
    dev = eng.device
    model = eng.model
    prefill_ms = {}
    for b in BUCKETS:
        prompt = torch.from_numpy(rs.randint(2, cfg.model.vocab_size,
                                             size=(1, b))).to(dev)
        model.prefill(prompt, 0, b)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(5):
            model.prefill(prompt, 0, b)
        torch.cuda.synchronize()
        prefill_ms[str(b)] = (time.perf_counter() - t) / 5 * 1e3
    tok = torch.from_numpy(rs.randint(2, cfg.model.vocab_size,
                                      size=SLOTS)).to(dev)
    pos = torch.arange(300, 300 + SLOTS, device=dev)
    model.decode_step(tok, pos)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(20):
        model.decode_step(tok, pos)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) / 20 * 1e3
    # the least time a step can take: it must read every weight (of the
    # embedding table only its SLOTS rows) and the whole K/V cache
    # (kv_decode_attention reads all max_len rows of every slot)
    step_bytes = sum(p.numel() * 4 for n, p in model.p.items()
                     if n != 'tok_emb.w') + SLOTS * cfg.model.d_model * 4 + \
        (model.k_cache.numel() + model.v_cache.numel()) * 4
    profile = step_profile(torch, lambda: model.decode_step(tok, pos))
    prompt = torch.from_numpy(rs.randint(2, cfg.model.vocab_size,
                                         size=(1, BUCKETS[-1]))).to(dev)
    pf_profile = step_profile(
        torch, lambda: model.prefill(prompt, 0, BUCKETS[-1]), steps=5)

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
        phase='engine', requests=N_REQUESTS, new_tokens=gen,
        warmup=warm, wall_s=wall, tokens_per_s=gen / wall,
        finish_reasons=sorted(set(reasons)), concurrent_equals_sequential=True,
        prefill_ms=prefill_ms, decode_step_ms=step_ms,
        decode_step_floor_ms=step_bytes / PEAK_BYTES_PER_S * 1e3,
        decode_step_bytes=step_bytes, decode_step_profile=profile,
        prefill_profile={str(BUCKETS[-1]): pf_profile},
        logits_max_abs_err_vs_cpu=logit_err, launches=counts,
        stats=eng.stats(), peak_mem_bytes=torch.cuda.max_memory_allocated())
    return summary, counts


def check_train_kernels(torch, F, phase, cfg, shapes, n_rows, ce_shapes):
    """Phases 5 and 11: the kernels a training step runs, but for flash
    attention, at one model's shapes: ``n_rows`` rows of ``cfg.d_model``,
    CE at each (rows, vocabulary) of ``ce_shapes``, Adam over the parameter
    ``shapes``. Returns {kernel name: summary dict} as check_kernels does."""
    from paddle_tpu_torch.ops import (ce_ops, embedding_ops, ffn_ops, nn_ops,
                                      optimizer_ops)
    dev = torch.device('cuda', 0)
    g = torch.Generator(device=dev).manual_seed(4321)
    N, V, D = n_rows, cfg.vocab_size, cfg.d_model

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    def timed(fn, plain, library, nbytes, flops, calls=5):
        b_ms, b_by = bound(nbytes, flops)
        return dict(ms=cuda_ms(torch, fn, calls=calls, replays=5),
                    eager_ms=eager_ms(torch, fn, iters=10, warmup=2),
                    plain_ms=cuda_ms(torch, plain, calls=calls, replays=5),
                    library_ms=library(), bound_ms=b_ms, bound_by=b_by)

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
        cases.append(dict(n=N, table_rows=rows, max_abs_err=err, **timed(
            lambda: embedding_ops.embedding_gather(w, ids),
            lambda: embedding_ops._gather_ref(w, ids),
            lambda: cuda_ms(torch, lambda: F.embedding(ids, w)),
            (N + min(N, rows)) * D * 4 + N * 8, 0, calls=20)))
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
    d_ff = cfg.d_ff
    w1, b1 = randn(D, d_ff, scale=0.02), randn(d_ff, scale=0.02)
    w2, b2 = randn(d_ff, D, scale=0.02), randn(D, scale=0.02)
    mask = (torch.rand((N, D), generator=g, device=dev) < 0.9).float() / 0.9
    err = max_err(torch, ffn_ops._ffn_fwd(x, w1, b1, w2, b2, mask, True),
                  ffn_ops._ffn_ref(x, w1, b1, w2, b2, mask))
    out['fused_ffn'] = dict(tolerance=1e-4, cases=[dict(
        n=N, d=D, d_ff=d_ff, max_abs_err=err, **timed(
            lambda: ffn_ops._ffn_fwd(x, w1, b1, w2, b2, mask, True),
            lambda: ffn_ops._ffn_ref(x, w1, b1, w2, b2, mask),
            lambda: cuda_ms(torch, lambda: (F.gelu(x @ w1 + b1) @ w2 + b2)
                            * mask),
            (2 * N * D + D * d_ff + d_ff + d_ff * D + D + N * d_ff + N * D)
            * 4, 4 * N * D * d_ff + 8 * N * d_ff))])
    del w, x, r, w1, w2, mask

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


def finish_kernel_checks(phase, out):
    """Emit every case of ``out`` and raise where a kernel's checked error
    exceeds its tolerance."""
    for name, res in out.items():
        key = res.setdefault('checked', 'max_abs_err')
        for k in {'max_abs_err', key}:
            res[k] = max(c[k] for c in res['cases'])
        for c in res['cases']:
            emit(dict(phase=phase, name=name, checked=key,
                      tolerance=res['tolerance'], **c))
        if not res[key] <= res['tolerance']:
            raise AssertionError('%s disagrees with its plain version: %s '
                                 '%g > %g' % (name, key, res[key],
                                              res['tolerance']))


def check_flash_kernels(torch, F):
    """Phase 8: the three flash kernels at the LM training shape and at
    BERT's (with the key-padding bias). Returns {kernel name: summary}."""
    from paddle_tpu_torch.ops import attention_ops as A
    dev = torch.device('cuda', 0)
    g = torch.Generator(device=dev).manual_seed(777)
    lens = np.random.RandomState(11).randint(32, 129, size=BERT_INFER_B)
    lens[0] = 0                       # one batch element wholly padded
    bias = torch.zeros(BERT_INFER_B, 128)
    for i, n in enumerate(lens):
        bias[i, n:] = -1e9
    shapes = [dict(shape='lm_train', B=TRAIN_B, H=8, L=512, dh=64,
                   causal=True, bias=None, pairs=TRAIN_B * 8 * 512 * 513 // 2),
              dict(shape='bert', B=BERT_INFER_B, H=12, L=128, dh=64,
                   causal=False, bias=bias.to(dev),
                   pairs=12 * 128 * int(lens.sum()))]
    names = FLASH_KERNELS
    out = {n: dict(tolerance=1e-4, cases=[]) for n in names}
    out[names[1]]['checked'] = out[names[2]]['checked'] = 'max_rel_err'
    for sh in shapes:
        B, H, L, dh, causal, bias = (sh[k] for k in (
            'B', 'H', 'L', 'dh', 'causal', 'bias'))
        bh, scale = B * H, dh ** -0.5
        q, k, v, do = (torch.randn((bh, L, dh), generator=g, device=dev)
                       for _ in range(4))
        args = (scale, causal, bias, H)
        o, lse = A._flash_fwd(q, k, v, *args)
        o_ref, lse_ref = A._attention_ref(q, k, v, *args)
        delta = (do * o).sum(dim=-1)
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

        def rel(got, want):
            return float((got - want).abs().max() / want.abs().max())

        common = dict(shape=sh['shape'], bh=bh, L=L, dh=dh, causal=causal,
                      biased=bias is not None, visible_pairs=sh['pairs'],
                      padded_element_exactly_zero=padded_zero)
        mat, row = bh * L * dh * 4, bh * L * 4
        extra = 0 if bias is None else bias.numel() * 4
        q4, k4, v4, do4 = (t.view(B, H, L, dh) for t in (q, k, v, do))
        mask4 = None if bias is None else bias.view(B, 1, 1, L)

        def sdpa(a, b, c):
            return F.scaled_dot_product_attention(a, b, c, attn_mask=mask4,
                                                  is_causal=causal)

        leaves = [t.detach().clone().requires_grad_() for t in (q4, k4, v4)]
        lib_out = sdpa(*leaves)
        lib_bwd = eager_ms(torch, lambda: torch.autograd.grad(
            lib_out, leaves, do4, retain_graph=True), iters=20, warmup=3)
        del lib_out, leaves

        def case(fn, plain, library_ms, nbytes, flops, **errs):
            b_ms, b_by = bound(nbytes, flops)
            return dict(common, ms=cuda_ms(torch, fn, calls=10, replays=5),
                        eager_ms=eager_ms(torch, fn, iters=10, warmup=2),
                        plain_ms=cuda_ms(torch, plain, calls=5, replays=5),
                        library_ms=library_ms, bound_ms=b_ms, bound_by=b_by,
                        **errs)

        out[names[0]]['cases'].append(case(
            lambda: A._flash_fwd(q, k, v, *args),
            lambda: A._attention_ref(q, k, v, *args),
            cuda_ms(torch, lambda: sdpa(q4, k4, v4), calls=10, replays=5),
            4 * mat + row + extra, 4 * dh * sh['pairs'],
            max_abs_err=max(float((o - o_ref).abs().max()),
                            float((lse - lse_ref)[live].abs().max()))))
        out[names[1]]['cases'].append(case(
            lambda: A._flash_bwd_dq(q, k, v, do, lse, delta, *args),
            lambda: A._bwd_dq_ref(q, k, v, do, lse, delta, *args),
            lib_bwd, 5 * mat + 2 * row + extra, 6 * dh * sh['pairs'],
            max_abs_err=float((dq - dq_ref).abs().max()),
            max_rel_err=rel(dq, dq_ref),
            largest_magnitude=dict(dq=float(dq_ref.abs().max())),
            library_covers='dQ, dK and dV in one call'))
        out[names[2]]['cases'].append(case(
            lambda: A._flash_bwd_dkv(q, k, v, do, lse, delta, *args),
            lambda: A._bwd_dkv_ref(q, k, v, do, lse, delta, *args),
            lib_bwd, 6 * mat + 2 * row + extra, 8 * dh * sh['pairs'],
            max_abs_err=max(float((dk - dk_ref).abs().max()),
                            float((dv - dv_ref).abs().max())),
            max_rel_err=max(rel(dk, dk_ref), rel(dv, dv_ref)),
            largest_magnitude=dict(dk=float(dk_ref.abs().max()),
                                   dv=float(dv_ref.abs().max())),
            library_covers='dQ, dK and dV in one call'))
        del q, k, v, do, o, lse, o_ref, lse_ref, dq, dk, dv, dq_ref, dk_ref
        del dv_ref, q4, k4, v4, do4
    finish_kernel_checks('flash_kernel', out)
    torch.cuda.empty_cache()
    return out


def train_step_grads(torch, cfg, params, tok, lab, dev):
    """(loss, {name: gradient on the CPU}, seconds) of one forward and
    backward of the LM on ``dev``."""
    from paddle_tpu_torch.models.transformer import TransformerLM
    model = TransformerLM(cfg, {k: v.to(dev) for k, v in params.items()},
                          cfg.seq_len)
    t = time.perf_counter()
    loss = model.loss(tok.to(dev), lab.to(dev))
    loss.backward()
    grads = {n: p.grad.cpu() for n, p in model.p.items()}
    return float(loss.detach()), grads, time.perf_counter() - t


def compare_train_step_with_cpu(torch, flash=False, unfused_card=None):
    """Phases 6 and 9: one full-width training forward and backward on the
    card and on the CPU, same weights and batch; with ``unfused_card`` (the
    card's result of phase 6) also flash against unfused on the card.
    Returns the card's (loss, gradients, seconds)."""
    from paddle_tpu_torch.models.transformer import LMConfig, init_params
    phase = 'flash_train_vs_cpu' if flash else 'train_vs_cpu'
    cfg = LMConfig(dropout=0.0, use_flash_attention=flash)
    params = init_params(cfg, 1, 'cpu')
    g = torch.Generator(device='cpu').manual_seed(5)
    tok = torch.randint(0, cfg.vocab_size, (2, cfg.seq_len), generator=g)
    lab = torch.randint(0, cfg.vocab_size, (2, cfg.seq_len), generator=g)
    card = train_step_grads(torch, cfg, params, tok, lab,
                            torch.device('cuda', 0))
    cpu = train_step_grads(torch, cfg, params, tok, lab, torch.device('cpu'))
    summary = dict(phase=phase, batch=2, seq_len=cfg.seq_len, flash=flash,
                   loss_card=card[0], loss_cpu=cpu[0], seconds_card=card[2],
                   seconds_cpu=cpu[2])
    pairs = [('cpu', cpu)] + ([('unfused_card', unfused_card)]
                              if unfused_card is not None else [])
    failures = []
    for what, other in pairs:
        loss_err = abs(card[0] - other[0])
        grad_rel = {n: float((card[1][n] - go).abs().max()
                             / go.abs().max().clamp_min(1e-30))
                    for n, go in other[1].items()}
        worst = max(grad_rel, key=grad_rel.get)
        summary['vs_' + what] = dict(
            loss_abs_err=loss_err, grad_rel_err_max=grad_rel[worst],
            grad_rel_err_worst_param=worst)
        if not (np.isfinite(card[0]) and loss_err <= 1e-4):
            failures.append('card vs %s training loss: %r vs %r'
                            % (what, card[0], other[0]))
        if not grad_rel[worst] <= 1e-3:
            failures.append('card vs %s gradient of %s differs by %g of its '
                            'largest magnitude' % (what, worst,
                                                   grad_rel[worst]))
    emit(summary)
    if failures:
        raise AssertionError('; '.join(failures))
    return card


def run_training(torch, kt, phase, cfg, kernels, note=None):
    """Phases 7 and 10: the flagship training step with ``cfg``. Returns
    (summary, counts)."""
    from paddle_tpu_torch.models.transformer import TransformerLM, init_params
    from paddle_tpu_torch.optimizer import Adam
    dev = torch.device('cuda', 0)
    model = TransformerLM(cfg, init_params(cfg, 2, dev), cfg.seq_len)
    opt = Adam(model.p, 1e-4, fuse=True)
    gen = torch.Generator(device=dev).manual_seed(2024)
    g = torch.Generator(device='cpu').manual_seed(6)
    tok = torch.randint(0, cfg.vocab_size, (TRAIN_B, cfg.seq_len),
                        generator=g).to(dev)
    lab = torch.randint(0, cfg.vocab_size, (TRAIN_B, cfg.seq_len),
                        generator=g).to(dev)
    summary, counts = timed_training(
        torch, kt, lambda: opt.minimize(model.loss(tok, lab, gen)),
        TRAIN_STEPS, kernels)
    summary = dict(
        phase=phase, batch=TRAIN_B, seq_len=cfg.seq_len, dropout=cfg.dropout,
        attn_dropout=cfg.attn_dropout, flash=model.flash_in_training(),
        tokens_per_s=TRAIN_B * cfg.seq_len / (summary['step_ms'] / 1e3),
        **summary)
    if note:
        summary['note'] = note
    return summary, counts


def timed_training(torch, kt, step, steps, kernels):
    """Run ``step`` (one training step returning its loss) ``steps`` times
    with the launch counts set to 0 just before: the loss finite and fallen
    by the last step, every kernel of ``kernels`` launched, the step's ms
    (first step apart), peak memory and a profile of one more step."""
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
    idle = [k for k in kernels if counts[k] <= 0]
    if idle:
        raise AssertionError('training kernels never launched: %s' % idle)
    return dict(steps=steps, losses=losses, loss_fall=losses[0] - losses[-1],
                first_step_ms=(t1 - t0) * 1e3,
                step_ms=(t2 - t1) / (steps - 1) * 1e3, peak_mem_bytes=peak,
                launches=counts,
                step_profile=step_profile(torch, step, steps=1)), counts


def run_bert(torch, kt):
    """Phase 12: BERT-base at full width. Returns (summary, counts of the
    training steps)."""
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.optimizer import Adam
    dev = torch.device('cuda', 0)
    cfg = bert.BertConfig(attn_dropout=0.0)      # dropout 0.1, flash trains
    params = bert.init_params(cfg, 3, 'cpu')
    model = bert.BertPretrain(cfg, {k: v.to(dev) for k, v in params.items()})

    def batch(n, seed, to):
        rs = np.random.RandomState(seed)
        feed = bert.make_pretrain_batch(cfg, n, rs)
        for i, keep in enumerate(rs.randint(32, cfg.seq_len + 1, size=n)):
            feed['input_mask'][i, keep:] = 0.0
        return {k: torch.from_numpy(v).to(to) for k, v in feed.items()}

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
    kt.reset_counts()
    with torch.no_grad():
        model.loss(is_test=True, **feed)
        torch.cuda.synchronize()
        infer_counts = kt.launch_counts()
        t = time.perf_counter()
        for _ in range(5):
            model.loss(is_test=True, **feed)
        torch.cuda.synchronize()
        infer_ms = (time.perf_counter() - t) / 5 * 1e3
        infer_profile = step_profile(
            torch, lambda: model.loss(is_test=True, **feed), steps=2)
    del feed
    torch.cuda.empty_cache()

    # (iv) training
    opt = Adam(model.p, 1e-4, fuse=True)
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


def main():
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
    emit(dict(phase='build', seconds=time.perf_counter() - t0,
              built=built['built'], nvcc=native.nvcc_path()))

    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.models.transformer import LMConfig, param_shapes

    kernels = check_kernels(torch, F, kt)
    engine, counts = run_engine(torch, kt)
    by_path = {'engine': counts}
    emit(engine)
    del engine
    torch.cuda.empty_cache()
    # kernels that several paths run come back with a case at each path's
    # shape: other[name][path] is that case
    other = {}

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
    compare_train_step_with_cpu(torch, flash=True, unfused_card=unfused_card)
    del unfused_card
    train_flash, by_path['train_flash'] = run_training(
        torch, kt, 'train_flash', LMConfig(attn_dropout=0.0),
        FLASH_TRAIN_KERNELS,
        note="the bench's flagship row also sets amp=True, which is not "
             "ported: this is f32")
    train_flash['unfused_step_ms'] = train['step_ms']
    train_flash['unfused_tokens_per_s'] = train['tokens_per_s']
    train_flash['unfused_peak_mem_bytes'] = train['peak_mem_bytes']
    emit(train_flash)
    del train, train_flash
    torch.cuda.empty_cache()

    bc = bert.BertConfig()
    merge('bert', check_train_kernels(
        torch, F, 'bert_kernel', bc, bert.param_shapes(bc).values(),
        BERT_TRAIN_B * bc.seq_len,
        [(BERT_TRAIN_B * bc.max_predictions, bc.vocab_size),
         (BERT_TRAIN_B, 2)]))
    bert_summary, by_path['bert'] = run_bert(torch, kt)
    emit(bert_summary)
    del bert_summary

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
    emit({'kernels': line})
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': kind,
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
