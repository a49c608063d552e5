"""Continuous-batching generative decode engine with a device-resident KV
cache — the port of paddle_tpu/serving/generate.py (contiguous and paged
modes).

- **KV cache on the card.** One pair of [slots, layers, heads, max_len,
  head_dim] tensors, allocated zeroed, updated in place by every prefill
  and decode step (the JAX engine returns a new cache that donation
  aliases onto the old buffer; here the write is in place).
- **Paged mode** (``GenerateConfig(paged=True)``) replaces the per-slot
  ``max_len`` rows with a pool of [num_blocks, layers, heads, block_size,
  head_dim] blocks that each slot addresses through a block table fed to
  every step (serving/kv_blocks.py): HBM is committed as sequences grow,
  admission is a blocks-available decision (a request waits in
  ``_pending_admit`` while the pool is dry), each step first grows the
  slots that cross into a new block, and a pool that runs dry finishes
  the starved request with ``finish_reason='cache_full'``. On top rides
  prefix sharing: prompts are chain-hashed per full block, a hit maps the
  request's leading table entries onto the blocks already holding that
  prefix (refcounted; copy-on-write of the last block when the whole
  prompt lands on shared blocks), and only the suffix is prefilled,
  bucketed by its own length. A suffix wider than the widest bucket
  prefills in bucket-wide chunks, each attending the cached prefix, so
  paged admission reaches ``max_len - 1`` tokens. The prefill attends
  through `kv_prefix_attention` in either flash setting.
- **Fixed signatures, replayed.** The JAX engine compiles one prefill
  program per prompt bucket and one decode-step program and dispatches
  them through `Executor.bind`. Here each signature is a `BoundStep`
  (serving/graphs.py): `warmup()` binds every one and on the card captures
  it as a CUDA graph (all of one engine's graphs share a memory pool);
  every later call writes the feeds into its static buffers with one
  host-to-device copy, replays, and the engine reads the result with one
  sync. The signatures: a prefill for each prompt bucket and the decode
  step, each greedy and sampled (`TransformerLM.prefill` or
  `prefill_paged` on the prompt padded to its bucket,
  `TransformerLM.decode_step` over every slot); a speculative engine adds
  the drafter, the verify step and, unless the draft is the target, the
  draft's prefills. On the CPU a bound step calls the model on the same
  static buffers. The model's own methods stay the eager path. What stays
  eager in the engine: the copy-on-write block copy and the draft cache's
  block copies (rare, a few copies each).
- **In-flight (continuous) batching.** Requests are admitted into free
  slots and finished or expired ones evicted at token boundaries, between
  decode steps. Every op of the step is slot-row-independent, so
  co-resident requests never perturb each other's numerics: a request's
  tokens under concurrent traffic equal its own `generate_once`.
- **Streaming and admission control.** Each `GenerateRequest` is a future
  and a token stream; the bounded queue sheds load with `LoadShedError`,
  and deadlines are enforced in the queue and mid-generation.
- **Sampling.** Per-request temperature / top-k / top-p with a private
  numpy Philox stream per request (`_sampling_stream`), byte-identical to
  the JAX engine's: the same ``sample_seed`` draws the same uniforms in
  both packages. Temperature 0 is greedy.
- **Speculative decoding** (``GenerateConfig(speculative=True)``, paged
  engines only). A draft LM with its own paged cache and block pool
  proposes ``spec_k`` greedy tokens a slot (`TransformerLM.draft_steps`:
  the steps' argmaxes feed each other on the device), then the target
  scores all ``spec_k + 1`` positions in one wide step
  (`TransformerLM.verify_step`). The engine accepts the longest draft
  prefix that agrees with the target's argmax plus the target's own next
  token, so every emitted token is the target's greedy token: the output
  is the plain engine's, up to ``spec_k + 1`` tokens a round. Rejected
  rows roll back by truncating the block tables (they sit past the write
  head, masked to exact 0; blocks that hold no accepted position go back
  to the pools): no cache byte moves. By default the draft is the
  target's own weights (aliased, not copied), and admission copies the
  target's prompt blocks into the draft pool instead of a draft prefill.
  While any resident samples, every round is a plain step
  (``spec_fallback_total``), and the residents' draft caches miss those
  positions until the next speculative round copies them across.

The JAX engine's monitor counters of the paged cache and of speculation
are kept in ``GenerateEngine.counters`` under the monitor's names
(``kv_block_cow_total``, ``kv_prefix_hit_total{outcome=hit|miss}``,
``kv_prefix_tokens_saved_total``; ``spec_propose_total``,
``spec_accept_total``, ``spec_fallback_total``,
``spec_stale_draft_rounds_total``).

Not ported yet (ROADMAP.md): the monitor / goodput / trace / black-box
hooks, and the metrics endpoint.
"""
import queue as _pyqueue
import threading
import time

import numpy as np
import torch

from ..framework import resolve_device
from ..io import params_from_numpy
from ..models.transformer import LMConfig, TransformerLM, init_params
from ..reader.bucketing import bucketize
from .batcher import (DeadlineExceededError, EngineStoppedError,
                      LoadShedError, Request, RequestQueue)
from .graphs import BoundStep
from .kv_blocks import BlockAllocator, PrefixCache, chain_hashes

__all__ = ['GenerateConfig', 'GenerateEngine', 'GenerateRequest',
           'GenerateResult']

_DONE = object()


def _sampling_stream(sample_seed):
    """One request's private sampling PRNG: a pinned seed replays the
    stream bit-exactly; None draws a fresh unpredictable one. Byte-identical
    to the JAX engine's, so a seed draws the same uniforms in both."""
    seed = sample_seed if sample_seed is not None \
        else np.random.SeedSequence().entropy
    return np.random.Generator(np.random.Philox(int(seed)))


class GenerateResult(list):
    """What ``GenerateRequest.result()`` returns: the generated token ids
    (it IS a list) plus ``finish_reason`` ('eos' | 'length' |
    'cache_full') and ``timing``: ``queue_s``, ``prefill_s``,
    ``decode_step_s`` (sum of the per-token gaps), ``total_s``,
    ``tokens``, ``step_s_mean`` / ``step_s_p99``; a request that rode a
    speculative round adds ``spec_proposed``, ``spec_accepted``,
    ``spec_accept_rate``, ``draft_s`` and ``verify_s`` (host seconds of
    its rounds' draft and verify legs)."""

    def __init__(self, tokens, finish_reason=None, timing=None):
        list.__init__(self, tokens)
        self.finish_reason = finish_reason
        self.timing = timing

    @property
    def tokens(self):
        return list(self)


class GenerateConfig(object):
    """Decode-engine knobs (the JAX engine's).

    - model: an `LMConfig`.
    - slots: KV-cache width, the most sequences in flight.
    - max_len: cache length per slot; a request that reaches it ends with
      finish_reason 'cache_full'.
    - prompt_buckets: ascending prompt-length ladder (prompts pad to their
      bucket). Default: powers of two from 16 up to max_len / 2.
    - eos_id: token ending a sequence (None = length-bounded only).
    - max_new_tokens: per-request cap when submit() gives none.
    - pad_id: prompt padding token.
    - queue_cap / default_deadline_s: bounded queue and default deadline.
    - seed: parameter-init seed when the engine gets no parameters.
    - idle_poll_s: how long an idle engine loop waits for work per poll.
    - temperature / top_k / top_p: engine-wide sampling defaults.
    - paged / block_size / num_blocks / prefix_sharing: paged-KV mode.
      ``num_blocks`` is the physical pool size (block 0 is the reserved
      trash block, so ``num_blocks - 1`` blocks are allocatable); the
      default matches the contiguous cache's HBM exactly
      (slots * max_len / block_size). ``prompt_buckets`` bucket the
      prefill SUFFIX in paged mode (with a prefix hit a request prefills
      only its uncached suffix).
    - speculative / spec_k / draft_model: speculative decoding (paged
      engines only). A draft LM proposes ``spec_k`` greedy tokens a slot
      each round and the target verifies them in one ``spec_k + 1``-wide
      step; greedy output stays the plain engine's. ``draft_model`` is the
      draft's LMConfig (its vocab must be the target's); None drafts with
      the target's own config and weights.
    - metrics_port: not ported yet; asking for it raises
      NotImplementedError.
    """

    def __init__(self, model=None, slots=8, max_len=256,
                 prompt_buckets=None, eos_id=None, max_new_tokens=64,
                 pad_id=0, queue_cap=256, default_deadline_s=60.0,
                 seed=0, idle_poll_s=0.02, temperature=0.0, top_k=0,
                 top_p=0.0, paged=False, block_size=16, num_blocks=None,
                 prefix_sharing=True, speculative=False, spec_k=4,
                 draft_model=None, metrics_port=None):
        if metrics_port is not None:
            raise NotImplementedError(
                'metrics_port is not ported to paddle_tpu_torch yet — see '
                'ROADMAP.md, Queue 1')
        self.model = model or LMConfig()
        self.slots = int(slots)
        self.max_len = int(max_len)
        if self.slots < 1:
            raise ValueError("slots must be >= 1")
        if self.max_len < 2:
            raise ValueError("max_len must be >= 2")
        self.paged = bool(paged)
        self.block_size = int(block_size)
        self.prefix_sharing = bool(prefix_sharing) and self.paged
        self.num_blocks = None
        if self.paged:
            if self.block_size < 1:
                raise ValueError("block_size must be >= 1")
            if self.max_len % self.block_size:
                raise ValueError(
                    "paged mode needs max_len (%d) divisible by "
                    "block_size (%d) — the block table is "
                    "max_len/block_size entries wide"
                    % (self.max_len, self.block_size))
            if num_blocks is None:
                num_blocks = self.slots * self.max_len // self.block_size
            self.num_blocks = int(num_blocks)
            if self.num_blocks < 2:
                raise ValueError("num_blocks must be >= 2 (block 0 is "
                                 "the reserved trash block)")
        self.speculative = bool(speculative)
        self.spec_k = int(spec_k)
        self.draft_model = draft_model
        if self.speculative:
            if not self.paged:
                raise ValueError(
                    "speculative decoding rides the paged KV engine "
                    "(rollback is block-table truncation) — pass "
                    "paged=True")
            if self.spec_k < 1:
                raise ValueError("spec_k must be >= 1")
            if draft_model is not None and \
                    draft_model.vocab_size != self.model.vocab_size:
                raise ValueError(
                    "draft_model.vocab_size (%d) must equal the target's "
                    "(%d) — draft proposals are target token ids"
                    % (draft_model.vocab_size, self.model.vocab_size))
        if prompt_buckets is None:
            prompt_buckets, b = [], 16
            while b <= self.max_len // 2:
                prompt_buckets.append(b)
                b *= 2
            if not prompt_buckets:
                prompt_buckets = [self.max_len // 2 or 1]
        self.prompt_buckets = sorted(set(int(b) for b in prompt_buckets))
        if not self.prompt_buckets:
            raise ValueError("prompt_buckets must not be empty")
        if self.prompt_buckets[0] < 1 or \
                self.prompt_buckets[-1] > self.max_len:
            raise ValueError(
                "prompt_buckets %r must lie in [1, max_len=%d]"
                % (prompt_buckets, self.max_len))
        self.eos_id = eos_id
        self.max_new_tokens = int(max_new_tokens)
        self.pad_id = int(pad_id)
        self.queue_cap = int(queue_cap)
        self.default_deadline_s = default_deadline_s
        self.seed = int(seed)
        self.idle_poll_s = float(idle_poll_s)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)


class GenerateRequest(Request):
    """One prompt in flight: a future (`result()` returns a
    `GenerateResult`) and a per-token stream (``for tok in
    req.stream()``)."""

    __slots__ = ('prompt', 'max_new_tokens', 'tokens', 'finish_reason',
                 'timing', 'step_s', 'queue_s', 'prefill_s', '_stream_q',
                 'temperature', 'top_k', 'top_p', 'sample_seed', '_rng',
                 'spec_rounds', 'spec_proposed', 'spec_accepted', 'draft_s',
                 'verify_s')

    def __init__(self, prompt, deadline, max_new_tokens, temperature=0.0,
                 top_k=0, top_p=0.0, sample_seed=None):
        Request.__init__(self, deadline)
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.tokens = []
        self.finish_reason = None
        self.timing = None
        self.step_s = []        # per-token gaps after the first token
        self.queue_s = 0.0
        self.prefill_s = 0.0
        self._stream_q = _pyqueue.Queue()
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.sample_seed = sample_seed
        self._rng = None
        self.spec_rounds = 0        # speculative rounds this request rode
        self.spec_proposed = 0      # draft tokens proposed for it
        self.spec_accepted = 0      # ... that became emitted tokens
        self.draft_s = 0.0
        self.verify_s = 0.0

    def _draw_u(self):
        """Next uniform of this request's own sampling stream (0.0 for a
        greedy request, which draws nothing)."""
        if self.temperature <= 0.0:
            return 0.0
        if self._rng is None:
            self._rng = _sampling_stream(self.sample_seed)
        return float(self._rng.random())

    def _emit(self, tok):
        self.tokens.append(tok)
        self._stream_q.put(tok)

    def _finish(self, reason):
        self.finish_reason = reason
        srt = sorted(self.step_s)
        t = {'queue_s': self.queue_s, 'prefill_s': self.prefill_s,
             'decode_step_s': sum(srt),
             'total_s': time.monotonic() - self.enqueue_t,
             'tokens': len(self.tokens), 'finish_reason': reason}
        if srt:
            t['step_s_mean'] = sum(srt) / len(srt)
            t['step_s_p99'] = srt[min(len(srt) - 1,
                                      int(np.ceil(0.99 * len(srt))) - 1)]
        if self.spec_rounds:
            t['spec_proposed'] = self.spec_proposed
            t['spec_accepted'] = self.spec_accepted
            t['spec_accept_rate'] = round(
                self.spec_accepted / float(self.spec_proposed), 4) \
                if self.spec_proposed else 0.0
            t['draft_s'] = self.draft_s
            t['verify_s'] = self.verify_s
        self.timing = t
        self.done(GenerateResult(self.tokens, finish_reason=reason,
                                 timing=t))
        self._stream_q.put(_DONE)

    def fail(self, error):
        Request.fail(self, error)
        self._stream_q.put(_DONE)

    def stream(self, timeout=None):
        """Yield generated tokens as they arrive; on a failed request the
        error raises AFTER the tokens already delivered. ``timeout`` bounds
        the wait for EACH token; without it the request's own deadline
        (+1 s grace) bounds every wait."""
        while True:
            t = timeout
            if t is None and self.deadline is not None:
                t = max(0.0, self.deadline - time.monotonic()) + 1.0
            try:
                item = self._stream_q.get(timeout=t)
            except _pyqueue.Empty:
                raise DeadlineExceededError(
                    "no token within %.3fs" % (t or 0.0))
            if item is _DONE:
                if self._error is not None:
                    raise self._error
                return
            yield item


class _Slot(object):
    __slots__ = ('req', 'pos', 'generated', 'last', 'last_t', 'blocks',
                 'table', 'dblocks', 'dtable', 'draft_stale')

    def __init__(self, req, pos, last, blocks=None, table=None,
                 dblocks=None, dtable=None):
        self.req = req
        self.pos = pos          # cache position the NEXT step writes
        self.generated = 1      # prefill already emitted the first token
        self.last = last        # last generated token (next step's input)
        self.last_t = time.perf_counter()
        self.blocks = blocks    # paged: physical block ids, table order
        self.table = table      # paged: np [max_blocks] int64, filler 0
        self.dblocks = dblocks  # speculative: the draft pool's block ids
        self.dtable = dtable    # speculative: the draft block table
        # a plain (fallback) step writes K/V into the target cache only:
        # the draft cache misses that row until a speculative round resyncs
        self.draft_stale = False


class GenerateEngine(object):
    """In-process continuous-batching decode engine. ::

        cfg = GenerateConfig(model=LMConfig(...), slots=8, max_len=256)
        engine = GenerateEngine(cfg)          # on cuda:0
        engine.warmup()                       # binds every signature
        with engine:                          # start()/stop()
            req = engine.submit(prompt_ids, max_new_tokens=32)
            for tok in req.stream():
                ...

    ``params`` is a {JAX parameter name: array} mapping (for example
    `paddle_tpu_torch.io.load_params` of a directory the JAX package
    saved); without it the engine initialises fresh weights from
    ``config.seed``. ``device`` None means ``cuda:0`` and raises without a
    card; pass ``device='cpu'`` to run on the CPU.

    ``block_allocator=`` (paged mode) injects a shared pool instead of the
    engine-private default: co-resident engines each take a
    `QuotaBlockAllocator` view over one `BlockAllocator` sized to the HBM
    budget. Its block_size must match the config's; the engine's prefix
    cache is built over the injected view, so pressure eviction stays
    tenant-local.

    A speculative engine's draft runs on ``draft_params`` (the counterpart
    of the JAX engine's ``draft_scope=``: a {name: array or tensor} mapping
    that `io.params_from_numpy` takes, for ``config.draft_model`` or, when
    that is None, the target's config). Tensors already on the device are
    used as they are, so a layer-skip draft built from the target's own
    ``tok_emb.w``, ``layer_0.*``, ``final_ln.*`` and ``lm_head.w`` shares
    their memory. Without ``draft_params`` a ``draft_model`` draft
    initialises from ``config.seed``, and with neither the draft is a
    second `TransformerLM` over the target's own parameter tensors.
    """

    def __init__(self, config=None, params=None, draft_params=None,
                 device=None, block_allocator=None):
        self.config = c = config or GenerateConfig()
        if block_allocator is not None and not c.paged:
            raise ValueError(
                "block_allocator= injection is a paged-mode feature "
                "(the contiguous cache reserves slots * max_len rows "
                "up front) — pass paged=True")
        self.device = resolve_device(device)
        if self.device.type == 'cuda':
            # the JAX package's f32 products are full f32: keep cuBLAS and
            # cuDNN off TF32 (a process-wide PyTorch setting)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        if params is None:
            weights = init_params(c.model, c.seed, self.device)
        else:
            weights = params_from_numpy(params, self.device, config=c.model)
        self.model = TransformerLM(c.model, weights, c.max_len)
        self._alloc = self._prefix = None
        if c.paged:
            if block_allocator is not None:
                if block_allocator.block_size != c.block_size:
                    raise ValueError(
                        "injected allocator block_size %d != config "
                        "block_size %d — the paged ops address the cache "
                        "through the table at the allocator's granularity"
                        % (block_allocator.block_size, c.block_size))
                pool = getattr(block_allocator, 'pool', block_allocator)
                if pool.num_blocks > c.num_blocks:
                    raise ValueError(
                        "injected pool has %d blocks, the config's cache %d "
                        "— every block id the pool hands out must address "
                        "this engine's cache" % (pool.num_blocks,
                                                 c.num_blocks))
                self._alloc = block_allocator
            else:
                self._alloc = BlockAllocator(c.num_blocks, c.block_size)
            if c.prefix_sharing:
                self._prefix = PrefixCache(self._alloc)
            self._max_blocks = c.max_len // c.block_size
            self.model.allocate_paged_cache(c.num_blocks, c.block_size)
        else:
            self._max_blocks = None
            self.model.allocate_cache(c.slots)
        self.draft = self._draft_alloc = None
        self._draft_copies_target = False
        if c.speculative:
            dcfg = c.draft_model or c.model
            if draft_params is not None:
                dweights = params_from_numpy(draft_params, self.device,
                                             config=dcfg)
            elif c.draft_model is not None:
                dweights = init_params(dcfg, c.seed, self.device)
            else:
                # the target's own tensors, aliased: the full-accept draft
                dweights = dict(self.model.p)
                self._draft_copies_target = True
            self.draft = TransformerLM(dcfg, dweights, c.max_len)
            # every slot at max_len plus the trash block: draft growth never
            # starves, so the draft pool needs no eviction or parking
            draft_nb = c.slots * c.max_len // c.block_size + 1
            self._draft_alloc = BlockAllocator(draft_nb, c.block_size)
            self.draft.allocate_paged_cache(draft_nb, c.block_size)
        # the bound signatures, their graphs' shared memory pool on the card
        self._graphs = {}
        self._pool = torch.cuda.graph_pool_handle() \
            if self.device.type == 'cuda' else None
        self._late_binds = 0
        self.queue = RequestQueue(c.queue_cap)
        self._slots = [None] * c.slots
        self._free = list(range(c.slots))[::-1]
        self._pending_admit = None   # popped, waiting for free blocks
        self._thread = None
        self._started = False
        self._warm = False
        self._stop_evt = threading.Event()
        self._lock = threading.Lock()
        self._decode_steps = 0
        self._decode_tokens = 0
        self._occ_sum = 0.0
        self._occ_peak = 0.0
        self._active_peak = 0
        self._blocks_peak = 0
        self._spec_rounds = 0
        self._spec_emitted = 0
        self._spec_draft_s = self._spec_verify_s = 0.0
        # the JAX engine's monitor counters of the paged cache, by name
        self.counters = {'kv_block_cow_total': 0,
                         'kv_prefix_hit_total{outcome=hit}': 0,
                         'kv_prefix_hit_total{outcome=miss}': 0,
                         'kv_prefix_tokens_saved_total': 0}
        if c.speculative:
            self.counters.update({'spec_propose_total': 0,
                                  'spec_accept_total': 0,
                                  'spec_fallback_total': 0,
                                  'spec_stale_draft_rounds_total': 0})

    # ------------------------------------------------------------------
    # bound signatures (serving/graphs.py): one per shape the engine
    # dispatches, captured as a CUDA graph on the card
    @property
    def graphs(self):
        """{signature key: `BoundStep`} of the signatures bound so far."""
        return dict(self._graphs)

    def _bound(self, key):
        """The `BoundStep` of signature ``key``, bound at its first use:
        ('step', sampled), ('prefill', bucket, sampled), ('prefill_paged',
        bucket, sampled, draft), ('drafter',) or ('verify',). A signature
        first bound after warmup() counts in
        ``stats()['graphs']['captures_after_warmup']``."""
        bs = self._graphs.get(key)
        if bs is None:
            fn, feeds = self._signature(key)
            bs = BoundStep(fn, feeds, self.device, pool=self._pool,
                           name='signature %r' % (key,))
            self._graphs[key] = bs
            if self._warm:
                self._late_binds += 1
            if self.device.type == 'cuda':
                # the graph captures the caches' addresses
                for m in (self.model, self.draft):
                    if m is not None:
                        m.cache_captured = True
        return bs

    def _signature(self, key):
        """(fn, feed specs) of signature ``key`` (see `_bound`). The
        functions hold the models, not the engine: an engine that its own
        bound steps referenced would be freed only by a cyclic collection,
        whose freeing of its graphs could land inside another capture."""
        c = self.config
        S, MB, i64, f32 = c.slots, self._max_blocks, 'int64', 'float32'
        kind = key[0]
        target, draft_lm, K = self.model, self.draft, c.spec_k

        def smp(n):     # temperature, top_k, top_p, u
            return [((n,), f32), ((n,), i64), ((n,), f32), ((n,), f32)]

        if kind == 'step':
            sampled = key[1]

            def fn(tok, pos, temp, topk, topp, u, tables=None):
                return target.decode_step(
                    tok, pos, (temp, topk, topp, u, sampled), tables=tables)
            feeds = [((S,), i64), ((S,), i64)] + smp(S)
            if c.paged:
                feeds.append(((S, MB), i64))
            return fn, feeds
        if kind == 'prefill':
            b, sampled = key[1:]

            def fn(prompt, slot, length, temp, topk, topp, u):
                return target.prefill(prompt, slot, length,
                                      (temp, topk, topp, u, sampled))
            return fn, [((1, b), i64), ((1,), i64), ((1,), i64)] + smp(1)
        if kind == 'prefill_paged':
            b, sampled, draft = key[1:]
            model = draft_lm if draft else target

            def fn(prompt, pos, table, length, temp, topk, topp, u):
                return model.prefill_paged(prompt, pos, table, length,
                                           (temp, topk, topp, u, sampled))
            return fn, [((1, b), i64), ((b,), i64), ((MB,), i64),
                        ((1,), i64)] + smp(1)
        W = K + 1
        if kind == 'drafter':
            def fn(tok, pos, tables, vmask):
                return (draft_lm.draft_steps(tok, pos, tables, vmask, K),)
            return fn, [((S,), i64), ((S,), i64), ((S, MB), i64),
                        ((S, W), i64)]
        if kind == 'verify':
            drafter = self._graphs[('drafter',)]

            def fn(pos, tables, vmask):
                # the verify rows, built on the device from the drafter's
                # feeds and drafts: each slot's last token, then its drafts
                # (an idle slot's row 0 is invalid: all token 0)
                toks, drafts = drafter.inputs[0], drafter.outputs[0]
                vt = torch.cat([toks[:, None], drafts], dim=1) * vmask[:, :1]
                verdict, logits = target.verify_step(vt, pos, tables, vmask)
                # drafts and verdict in one tensor: one read a round
                return torch.cat([drafts.reshape(-1), verdict]), logits
            return fn, [((S, W), i64), ((S, MB), i64), ((S, W), i64)]
        raise KeyError(key)

    @staticmethod
    def _sample_feeds(rows):
        """The sampling feeds (temperature f32, top_k int64, top_p f32, u
        f32 [n]) of per-row tuples (temperature, top_k, top_p, u), and
        whether any row samples."""
        a = np.asarray(rows, dtype=np.float64).reshape(-1, 4)
        return ([a[:, 0].astype(np.float32), a[:, 1].astype(np.int64),
                 a[:, 2].astype(np.float32), a[:, 3].astype(np.float32)],
                bool((a[:, 0] > 0).any()))

    def _tensors(self, *arrays):
        """Int64 device tensors of ``arrays`` (their shapes kept) through
        one host-to-device copy (the eager block copies)."""
        flat = torch.from_numpy(np.concatenate(
            [np.asarray(a, 'int64').reshape(-1) for a in arrays])).to(
                self.device)
        out, at = [], 0
        for a in arrays:
            n = int(np.size(a))
            out.append(flat[at:at + n].view(np.shape(a)))
            at += n
        return out

    def _run_prefill(self, slot, prompt, sample=(0.0, 0, 0.0, 0.0),
                     table=None, ctx_len=0, draft=False):
        """Prefill ``prompt`` into ``slot`` (contiguous) or, paged, its
        uncached suffix through ``table``; returns the first token.
        ``draft`` prefills the draft's cache (a speculative admission)."""
        c = self.config
        smp, sampled = self._sample_feeds([sample])
        if table is None:
            b = bucketize(prompt.size, c.prompt_buckets)
            padded = np.full((1, b), c.pad_id, 'int64')
            padded[0, :prompt.size] = prompt
            tok, _ = self._bound(('prefill', b, sampled))(
                padded, np.array([slot], 'int64'),
                np.array([prompt.size], 'int64'), *smp)
            return int(tok[0])
        # paged: only the uncached suffix is computed, bucketed by its own
        # length; a suffix wider than the widest bucket runs in chunks of
        # that width (the widest bucket's greedy signature at length =
        # wide), each depositing its K/V and attending the cached prefix
        # like a shared-prefix suffix. Only the final chunk's token is the
        # answer.
        wide = c.prompt_buckets[-1]
        table = np.asarray(table, 'int64')
        off = int(ctx_len)
        suffix = prompt[off:]
        greedy, _ = self._sample_feeds([(0.0, 0, 0.0, 0.0)])
        while suffix.size > wide:
            chunk, suffix = suffix[:wide], suffix[wide:]
            pos = np.clip(off + np.arange(wide), 0, c.max_len - 1)
            self._bound(('prefill_paged', wide, False, draft))(
                chunk[None], pos, table, np.array([wide], 'int64'),
                *greedy)
            off += wide
        b = bucketize(suffix.size, c.prompt_buckets)
        padded = np.full((1, b), c.pad_id, 'int64')
        padded[0, :suffix.size] = suffix
        pos = np.clip(off + np.arange(b), 0, c.max_len - 1)
        tok, _ = self._bound(('prefill_paged', b, sampled, draft))(
            padded, pos, table, np.array([suffix.size], 'int64'), *smp)
        return int(tok[0])

    def _run_step(self, rows, tables=None):
        """One decode step over every slot; ``rows`` maps slot index to
        (last token, position, (temperature, top_k, top_p, u)) and, paged,
        ``tables`` slot index to its block table. Idle slots feed token 0
        at position 0 (paged: against an all-zero table row, so they write
        to the trash block). Returns next tokens as numpy [S]."""
        c = self.config
        S = c.slots
        toks = np.zeros((2, S), 'int64')
        sample = [(0.0, 0, 0.0, 0.0)] * S
        for i, (last, pos, smp) in rows.items():
            toks[0, i], toks[1, i] = last, pos
            sample[i] = smp
        smp, any_sampled = self._sample_feeds(sample)
        feeds = [toks[0], toks[1]] + smp
        if c.paged:
            btab = np.zeros((S, self._max_blocks), 'int64')
            for i, table in (tables or {}).items():
                btab[i] = table
            feeds.append(btab)
        nxt, _ = self._bound(('step', any_sampled))(*feeds)
        return nxt.cpu().numpy().copy()

    # ------------------------------------------------------------------
    # paged helpers
    def _cow_copy(self, src, dst):
        """Copy-on-write: duplicate physical block ``src`` into ``dst`` in
        both caches, on the device."""
        for cache in (self.model.k_cache, self.model.v_cache):
            cache[dst] = cache[src]

    def _draft_cache_sync(self, dblocks, blocks):
        """Draft == target: the draft prefill would recompute exactly the
        K/V rows the target holds (same weights, same inputs), so copy the
        target's ``blocks`` into the draft pool's ``dblocks`` on the device
        instead, in both caches."""
        d_ids, s_ids = self._tensors(dblocks, blocks)
        for dst, src in ((self.draft.k_cache, self.model.k_cache),
                         (self.draft.v_cache, self.model.v_cache)):
            dst[d_ids] = src[s_ids]

    def _alloc_blocks(self, n):
        """n blocks, evicting idle prefix-cache entries under pressure;
        None when the pool cannot satisfy the request."""
        ids = self._alloc.alloc(n)
        if ids is None and self._prefix is not None:
            self._prefix.evict_for(n)
            ids = self._alloc.alloc(n)
        if ids is not None:
            self._blocks_peak = max(self._blocks_peak, self._alloc.in_use())
        return ids

    def _slot_table(self, blocks):
        table = np.zeros((self._max_blocks,), 'int64')
        table[:len(blocks)] = blocks
        return table

    def _paged_plan(self, req):
        """Block plan for one admission: (blocks, ctx_len, hashes).
        ``blocks`` covers the whole prompt in logical order: prefix-cache
        hits mapped to their existing physical blocks (referenced), fresh
        blocks for the rest, and a copy-on-write duplicate of the final
        shared block when the ENTIRE prompt landed on shared blocks (its
        last position must be recomputed, a divergent write). None when
        the pool cannot satisfy the request now (nothing referenced,
        nothing allocated)."""
        bs = self.config.block_size
        L = req.prompt.size
        total = -(-L // bs)
        shared, hashes = [], []
        if self._prefix is not None:
            hashes = chain_hashes(req.prompt, bs)
            shared = self._prefix.match(hashes)
        cow = bool(shared) and len(shared) * bs >= L
        n_keep = len(shared) - (1 if cow else 0)
        ctx_len = min(n_keep * bs + (bs if cow else 0), L - 1)
        # pin every matched block (the COW source too) BEFORE touching the
        # allocator: under pressure _alloc_blocks evicts refcount-1 prefix
        # entries, and an unpinned match could be recycled as "fresh" — a
        # duplicate id in the plan, the suffix prefill clobbering its own
        # cached prefix
        pinned = shared[:n_keep] + (shared[-1:] if cow else [])
        for b in pinned:
            self._alloc.ref(b)
        new_ids = self._alloc_blocks(total - n_keep)
        if new_ids is None:
            self._alloc.deref_many(pinned)
            return None
        if cow:
            self._cow_copy(shared[-1], new_ids[0])
            self._alloc.deref(shared[-1])   # pinned only for the copy
            self.counters['kv_block_cow_total'] += 1
        if self._prefix is not None:
            self.counters['kv_prefix_hit_total{outcome=%s}' % (
                'hit' if ctx_len > 0 else 'miss')] += 1
            self.counters['kv_prefix_tokens_saved_total'] += ctx_len
        return shared[:n_keep] + new_ids, ctx_len, hashes

    def _grow_blocks(self):
        """Before a paged step: a resident whose next write position
        crosses into an unallocated block gets one more block; a dry pool
        (even after prefix-cache eviction) finishes that request with
        'cache_full' and returns its blocks — its neighbours decode on."""
        bs = self.config.block_size
        for i, st in enumerate(self._slots):
            if st is None or st.pos // bs < len(st.blocks):
                continue
            grown = self._alloc_blocks(1)
            if grown is None:
                self._release(i)
                st.req._finish('cache_full')
                continue
            st.table[len(st.blocks)] = grown[0]
            st.blocks.append(grown[0])
        self._set_occupancy()

    # ------------------------------------------------------------------
    # warmup + lifecycle
    def warmup(self):
        """Bind every signature the engine dispatches and run it once (on
        the card: build the kernels, capture each one's CUDA graph): each
        prompt bucket's prefill and the decode step, greedy and sampled; a
        speculative engine also the draft's prefills (greedy; unless the
        draft is the target, whose admissions copy blocks instead), the
        drafter and the verify step. A contiguous engine's warmup writes
        slot 0's rows and row 0 of every slot, a paged one's only the trash
        block (all-zero tables). Returns {'buckets', 'signatures' (bound),
        'graphs' (captured), 'seconds'}."""
        if self._started:
            raise RuntimeError(
                "warmup() runs the prefill/decode path against the live KV "
                "cache and must not race the started engine loop — warm up "
                "before start() (start() warms up automatically)")
        t0 = time.perf_counter()
        c = self.config
        zero_table = None if not c.paged else np.zeros(self._max_blocks,
                                                       'int64')
        for b in c.prompt_buckets:
            for temp in (0.0, 1.0):
                self._run_prefill(0, np.zeros((b,), 'int64'),
                                  (temp, 0, 0.0, 0.0), table=zero_table)
            if c.speculative and not self._draft_copies_target:
                self._run_prefill(0, np.zeros((b,), 'int64'),
                                  table=zero_table, draft=True)
        for temp in (0.0, 1.0):
            self._run_step({0: (0, 0, (temp, 0, 0.0, 0.0))})
        if c.speculative:
            S, W = c.slots, c.spec_k + 1
            zeros = np.zeros((S, self._max_blocks), 'int64')
            self._bound(('drafter',))(np.zeros(S, 'int64'),
                                      np.zeros(S, 'int64'), zeros,
                                      np.zeros((S, W), 'int64'))
            self._bound(('verify',))(np.zeros((S, W), 'int64'), zeros,
                                     np.zeros((S, W), 'int64'))
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        self._warm = True
        return {'buckets': len(self.config.prompt_buckets),
                'signatures': len(self._graphs),
                'graphs': sum(1 for g in self._graphs.values()
                              if g.captured),
                'seconds': round(time.perf_counter() - t0, 3)}

    def start(self):
        with self._lock:
            if self._started:
                return self
            if self.queue.closed:
                raise EngineStoppedError(
                    "a stopped GenerateEngine cannot restart — build a "
                    "fresh engine (the queue already failed its callers)")
            if not self._warm:
                self.warmup()
            self._started = True
            self._stop_evt.clear()
            self._thread = threading.Thread(target=self._loop,
                                            name='paddle-torch-generate',
                                            daemon=True)
            self._thread.start()
        return self

    def stop(self, timeout_s=10.0):
        """Close the queue (queued requests fail with EngineStoppedError),
        fail resident generations, join the decode loop; a paged engine
        then drops its prefix cache's block references."""
        with self._lock:
            self._started = False
        self._stop_evt.set()
        self.queue.close()
        if self._thread is not None:
            self._thread.join(timeout_s)
            self._thread = None
        if self._prefix is not None:
            # a stopped engine serves no more hits
            self._prefix.drop_all()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # ------------------------------------------------------------------
    # request path
    def submit(self, prompt, max_new_tokens=None, deadline_s=None,
               temperature=None, top_k=None, top_p=None, sample_seed=None):
        """Enqueue one prompt (1-D int token ids); returns the
        `GenerateRequest`. Raises ValueError for an empty prompt or one
        longer than the largest bucket (paged engines: than max_len - 1,
        the chunked-prefill bound) and `LoadShedError` when the queue is
        full. Sampling arguments default to the config's; temperature <= 0
        is greedy; ``sample_seed`` pins the request's sampling stream."""
        c = self.config
        prompt = np.asarray(prompt, dtype='int64').reshape(-1)
        if c.paged:
            # chunked prefill lifts admission past the ladder: one row must
            # remain for the first decode write
            limit = c.max_len - 1
            why = "max_len - 1 (chunked-prefill admission bound)"
        else:
            limit = c.prompt_buckets[-1]
            why = ("largest prompt bucket — trim the prompt, widen "
                   "prompt_buckets, or use paged=True (chunked prefill "
                   "admits up to max_len - 1)")
        if prompt.size < 1 or prompt.size > limit:
            raise ValueError("prompt length %d outside [1, %d] (%s)"
                             % (prompt.size, limit, why))
        if max_new_tokens is None:
            max_new_tokens = c.max_new_tokens
        if int(max_new_tokens) < 1:
            raise ValueError("max_new_tokens must be >= 1")
        temperature = c.temperature if temperature is None \
            else float(temperature)
        top_k = c.top_k if top_k is None else int(top_k)
        top_p = c.top_p if top_p is None else float(top_p)
        if top_p < 0.0 or top_p > 1.0:
            raise ValueError("top_p must lie in [0, 1] — 0 (or 1) "
                             "disables nucleus sampling")
        if deadline_s is None:
            deadline_s = c.default_deadline_s
        deadline = (time.monotonic() + deadline_s
                    if deadline_s is not None else None)
        req = GenerateRequest(prompt, deadline, int(max_new_tokens),
                              temperature=temperature, top_k=top_k,
                              top_p=top_p, sample_seed=sample_seed)
        try:
            self.queue.put(req)
        except (LoadShedError, EngineStoppedError) as e:
            req.fail(e)
            raise
        return req

    def generate(self, prompt, max_new_tokens=None, deadline_s=None,
                 timeout=None, temperature=None, top_k=None, top_p=None,
                 sample_seed=None):
        """Blocking convenience: submit + result (the generated tokens)."""
        return self.submit(prompt, max_new_tokens=max_new_tokens,
                           deadline_s=deadline_s, temperature=temperature,
                           top_k=top_k, top_p=top_p,
                           sample_seed=sample_seed).result(timeout)

    def generate_once(self, prompt, max_new_tokens=None, temperature=0.0,
                      top_k=0, top_p=0.0, sample_seed=None):
        """Synchronous single-prompt decode on slot 0 through the same
        prefill and decode step the loop runs — the sequential reference
        the concurrent engine is held to. Greedy by default; a pinned
        ``sample_seed`` replays submit()'s sampling stream. Only valid
        while the engine is NOT started. A paged engine allocates the
        reference's blocks from the live pool (bypassing the prefix cache:
        fresh blocks, the whole prompt prefilled) and returns every block
        before returning."""
        if self._started:
            raise RuntimeError(
                "generate_once drives the decode path inline and must not "
                "race the started engine loop — use submit()")
        c = self.config
        prompt = np.asarray(prompt, dtype='int64').reshape(-1)
        if max_new_tokens is None:
            max_new_tokens = c.max_new_tokens
        req = GenerateRequest(prompt, None, int(max_new_tokens),
                              temperature=temperature, top_k=top_k,
                              top_p=top_p, sample_seed=sample_seed)
        smp = (req.temperature, req.top_k, req.top_p)
        blocks, table = None, None
        if c.paged:
            blocks = self._alloc_blocks(-(-prompt.size // c.block_size))
            if blocks is None:
                raise RuntimeError(
                    "paged KV pool cannot hold a %d-token prompt right now "
                    "(%d blocks free of %d)" % (prompt.size,
                                                self._alloc.available(),
                                                self._alloc.capacity))
            table = self._slot_table(blocks)
        try:
            first = self._run_prefill(0, prompt, smp + (req._draw_u(),),
                                      table=table)
            tokens, last, pos = [first], first, prompt.size
            while (len(tokens) < max_new_tokens and pos < c.max_len and
                   (c.eos_id is None or last != c.eos_id)):
                if c.paged and pos // c.block_size >= len(blocks):
                    grown = self._alloc_blocks(1)
                    if grown is None:     # pool dry: cache_full semantics
                        break
                    table[len(blocks)] = grown[0]
                    blocks.append(grown[0])
                nxt = self._run_step({0: (last, pos,
                                          smp + (req._draw_u(),))},
                                     tables={0: table})
                last = int(nxt[0])
                tokens.append(last)
                pos += 1
            return tokens
        finally:
            if blocks:
                self._alloc.deref_many(blocks)

    # ------------------------------------------------------------------
    # decode loop
    def _loop(self):
        poll = self.config.idle_poll_s
        while not self._stop_evt.is_set():
            self._evict_expired()
            self._admit()
            if not any(s is not None for s in self._slots):
                if self._pending_admit is not None:
                    # parked for blocks with nothing resident: _admit()
                    # retries it every pass (with no residents the prefix
                    # cache is wholly evictable, so this is transient)
                    time.sleep(poll)
                    continue
                req, expired = self.queue.take(poll)
                self._fail_expired(expired)
                if req is not None:
                    self._admit_one(req)
                continue
            self._step()
        for i, st in enumerate(self._slots):
            if st is not None:
                self._release(i)
                st.req.fail(EngineStoppedError(
                    "engine stopped after %d generated tokens"
                    % st.generated))
        if self._pending_admit is not None:
            req, self._pending_admit = self._pending_admit, None
            req.fail(EngineStoppedError(
                "engine stopped while the request waited for KV blocks"))

    def _admit(self):
        while self._free and not self._stop_evt.is_set():
            req, self._pending_admit = self._pending_admit, None
            if req is None:
                req, expired = self.queue.take(0.0)
                self._fail_expired(expired)
                if req is None:
                    return
            if not self._admit_one(req):
                return      # parked for blocks: retried next boundary

    def _admit_one(self, req):
        """Admit one popped request. False when a paged engine must wait
        for blocks (the request parks in ``_pending_admit``); True when
        the request was consumed: admitted, finished or failed."""
        c = self.config
        blocks, table, ctx_len, hashes = None, None, 0, []
        dblocks, dtable = None, None
        if c.paged:
            if -(-req.prompt.size // c.block_size) > self._alloc.capacity:
                # no eviction can ever fit this prompt
                req._finish('cache_full')
                return True
            plan = self._paged_plan(req)
            if plan is None:
                self._pending_admit = req
                return False
            blocks, ctx_len, hashes = plan
            table = self._slot_table(blocks)
        slot = self._free.pop()
        req.queue_s = max(0.0, time.monotonic() - req.enqueue_t)
        t0 = time.perf_counter()
        try:
            first = self._run_prefill(
                slot, req.prompt,
                (req.temperature, req.top_k, req.top_p, req._draw_u()),
                table=table, ctx_len=ctx_len)
            if c.speculative:
                # the draft tracks the request in its own pool: the whole
                # prompt (no prefix cache), copied from the target's blocks
                # when the draft is the target, else prefilled like the
                # target's (chunked)
                dblocks = self._draft_alloc.alloc(
                    -(-req.prompt.size // c.block_size))
                if dblocks is None:     # unreachable by the pool's sizing
                    raise RuntimeError("draft KV pool exhausted")
                dtable = self._slot_table(dblocks)
                if self._draft_copies_target:
                    self._draft_cache_sync(dblocks, blocks)
                else:
                    self._run_prefill(slot, req.prompt, table=dtable,
                                      draft=True)
        except Exception as e:  # noqa: BLE001 — delivered to the request
            self._free.append(slot)
            if blocks:
                self._alloc.deref_many(blocks)
            if dblocks:
                self._draft_alloc.deref_many(dblocks)
            req.fail(e)
            return True
        if self._prefix is not None:
            # publish the prompt's full blocks (immutable once prefilled:
            # decode writes land past the prompt)
            for i, h in enumerate(hashes):
                self._prefix.register(h, i, blocks[i])
        req.prefill_s = time.perf_counter() - t0
        self._decode_tokens += 1
        req._emit(first)
        st = _Slot(req, pos=req.prompt.size, last=first, blocks=blocks,
                   table=table, dblocks=dblocks, dtable=dtable)
        reason = self._finish_reason(st)
        if reason:
            self._release_blocks(st)
            self._free.append(slot)
            req._finish(reason)
        else:
            self._slots[slot] = st
        self._set_occupancy()
        return True

    def _step(self):
        """One token boundary's work: a speculative round when the engine
        speculates and every resident is greedy, else one plain decode step
        (on a speculative engine with residents, a counted fallback)."""
        if self._spec_ready():
            self._spec_round()
            return
        if self.config.speculative and any(self._slots):
            self.counters['spec_fallback_total'] += 1
        self._plain_step()

    def _plain_step(self):
        if self.config.paged:
            self._grow_blocks()
        active = [(i, st) for i, st in enumerate(self._slots)
                  if st is not None]
        if not active:
            return
        rows, tables = {}, {}
        for i, st in active:
            r = st.req
            rows[i] = (st.last, st.pos,
                       (r.temperature, r.top_k, r.top_p, r._draw_u()))
            tables[i] = st.table
        try:
            nxt = self._run_step(rows, tables)
        except Exception as e:  # noqa: BLE001 — fails the residents only
            self._fail_residents(active, e)
            return
        now = time.perf_counter()
        self._decode_steps += 1
        self._decode_tokens += len(active)
        self._occ_sum += len(active) / float(self.config.slots)
        for i, st in active:
            st.pos += 1
            st.generated += 1
            st.last = int(nxt[i])
            # on a speculative engine this row went to the target only
            st.draft_stale = self.config.speculative
            st.req.step_s.append(max(0.0, now - st.last_t))
            st.last_t = now
            st.req._emit(st.last)
            reason = self._finish_reason(st)
            if reason:
                self._release(i)
                st.req._finish(reason)
        self._set_occupancy()

    # ------------------------------------------------------------------
    # speculative decoding
    def _spec_ready(self):
        """Speculate this round: a speculative engine with residents, all
        greedy (a sampled row has no argmax rule to accept by)."""
        if not self.config.speculative:
            return False
        active = [st for st in self._slots if st is not None]
        return bool(active) and all(st.req.temperature <= 0.0
                                    for st in active)

    def _spec_grow(self, active):
        """Before a round: extend each slot's target table over the verify
        window's write positions (pos .. pos + spec_k, capped at max_len -
        1) and its draft table to the same coverage (the drafter's trailing
        write-only step deposits pos + spec_k too). Returns {slot index:
        n_valid}, the verify rows fully budgeted by cache coverage, max_len
        and the request's remaining tokens (so the accept rate measures the
        draft, not the budget). A pool too dry to extend the tail shortens
        this round's window (n_valid >= 1: `_grow_blocks` already holds the
        next write's block); it never starves a request."""
        c = self.config
        bs, K = c.block_size, c.spec_k
        n_valid = {}
        for i, st in active:
            want_last = min(st.pos + K, c.max_len - 1) // bs
            while len(st.blocks) <= want_last:
                grown = self._alloc_blocks(1)
                if grown is None:
                    break
                st.table[len(st.blocks)] = grown[0]
                st.blocks.append(grown[0])
            covered = len(st.blocks) * bs - 1       # last writable position
            remaining = st.req.max_new_tokens - st.generated
            n_valid[i] = max(1, min(K + 1, c.max_len - st.pos,
                                    covered - st.pos + 1, remaining))
            while len(st.dblocks) <= want_last:
                grown = self._draft_alloc.alloc(1)
                if grown is None:       # unreachable by the pool's sizing
                    break
                st.dtable[len(st.dblocks)] = grown[0]
                st.dblocks.append(grown[0])
        return n_valid

    def _spec_truncate(self, st):
        """Roll back the speculative tail: blocks that hold no position
        below the write head and are not the next write's block go back to
        their pools, their table entries to 0 (the trash block). No cache
        byte moves: rejected rows sit past the write head, where every
        attention masks them to exact 0. Keeping the next write's block (not
        just ceil(pos / bs)) keeps the plain path's rule that a resident
        never frees the block its next token lands in: freed after an accept
        that ends on a block edge, another slot could take it and this
        one's next growth would end in a false 'cache_full'."""
        keep = min(self._max_blocks, st.pos // self.config.block_size + 1)
        for blocks, table, alloc in ((st.blocks, st.table, self._alloc),
                                     (st.dblocks, st.dtable,
                                      self._draft_alloc)):
            while len(blocks) > keep:
                alloc.deref(blocks.pop())
                table[len(blocks)] = 0

    def _spec_round(self):
        """One speculative round over the (all-greedy) residents: the
        drafter proposes spec_k tokens a slot from the draft's cache, the
        verify step scores all spec_k + 1 positions with the target, and
        the host accepts the longest draft prefix the target's argmax
        agrees with plus the target's own next token, cut at the budget
        and at eos. The drafts and the verdict come back in one host sync.
        Rejected rows roll back by block-table truncation."""
        c = self.config
        self._grow_blocks()     # the plain growth (may end in cache_full)
        active = [(i, st) for i, st in enumerate(self._slots)
                  if st is not None]
        if not active:
            return
        K, W, S = c.spec_k, c.spec_k + 1, c.slots
        n_valid = self._spec_grow(active)
        if max(n_valid.values()) <= 1:
            # no resident can take a proposal: a plain step is cheaper
            self._plain_step()
            return
        # fallback steps wrote their positions into the target cache only;
        # a draft that is the target gets those blocks copied across (the
        # tables already cover them), another draft catches up as its own
        # steps write past them
        stale = [st for _, st in active if st.draft_stale]
        if stale:
            self.counters['spec_stale_draft_rounds_total'] += 1
            for st in stale:
                n = min(len(st.dblocks), len(st.blocks))
                if self._draft_copies_target and n:
                    self._draft_cache_sync(st.dblocks[:n], st.blocks[:n])
                st.draft_stale = False

        idx = np.array([i for i, _ in active])
        posv = np.array([st.pos for _, st in active], 'int64')
        toks = np.zeros(S, 'int64')
        pos = np.zeros(S, 'int64')
        dbtab = np.zeros((S, self._max_blocks), 'int64')
        vbtab = np.zeros((S, self._max_blocks), 'int64')
        toks[idx] = [st.last for _, st in active]
        pos[idx] = posv
        for i, st in active:
            dbtab[i] = st.dtable
            vbtab[i] = st.table
        dlim = np.array([min(c.max_len, len(st.dblocks) * c.block_size)
                         for _, st in active], 'int64')
        dvm = np.zeros((S, W), 'int64')
        dvm[idx] = np.arange(W)[None, :] < \
            np.clip(dlim - posv, 0, W)[:, None]
        vp = np.zeros((S, W), 'int64')
        vv = np.zeros((S, W), 'int64')
        vp[idx] = np.clip(posv[:, None] + np.arange(W)[None, :], 0,
                          c.max_len - 1)
        nvs = np.array([n_valid[i] for i, _ in active], 'int64')
        vv[idx] = np.arange(W)[None, :] < nvs[:, None]
        t0 = time.perf_counter()
        try:
            self._bound(('drafter',))(toks, pos, dbtab, dvm)
            t1 = time.perf_counter()
            both, _ = self._bound(('verify',))(vp, vbtab, vv)
        except Exception as e:  # noqa: BLE001 — fails the residents only
            self._fail_residents(active, e)
            return
        # admit queued prompts while the verify step runs on the card (the
        # prefills' own bound steps: their feeds and outputs are their own)
        t_adm = time.perf_counter()
        self._admit()
        adm_s = time.perf_counter() - t_adm
        try:
            both = both.cpu().numpy().copy()
        except Exception as e:  # noqa: BLE001 — fails the residents only
            self._fail_residents(active, e)
            return
        now = time.perf_counter()
        draft_s = t1 - t0
        verify_s = max(0.0, now - t1 - adm_s)
        drafts = both[:S * K].reshape(S, K)
        verdict = both[S * K:].reshape(S, W)

        self._decode_steps += 1
        round_proposed = round_accepted = emitted_total = 0
        # the longest draft prefix the target's argmax agrees with, a slot
        agree = drafts[idx] == verdict[idx, :K]             # [n, K]
        runs = np.where(agree.all(axis=1), K, np.argmax(~agree, axis=1))
        for (i, st), run in zip(active, runs.tolist()):
            r = st.req
            nv = n_valid[i]
            m = min(1 + min(run, nv - 1), r.max_new_tokens - st.generated)
            emitted = [int(t) for t in verdict[i, :m]]
            if c.eos_id is not None and c.eos_id in emitted:
                emitted = emitted[:emitted.index(c.eos_id) + 1]
                m = len(emitted)
            accepted = max(0, m - 1)
            round_proposed += nv - 1
            round_accepted += accepted
            r.spec_rounds += 1
            r.spec_proposed += nv - 1
            r.spec_accepted += accepted
            r.draft_s += draft_s
            r.verify_s += verify_s
            st.pos += m
            st.generated += m
            st.last = emitted[-1]
            self._spec_truncate(st)
            per_tok = max(0.0, now - st.last_t) / m
            st.last_t = now
            for tok in emitted:
                r.step_s.append(per_tok)
                r._emit(tok)
            emitted_total += m
            reason = self._finish_reason(st)
            if reason:
                self._release(i)
                r._finish(reason)
        self._decode_tokens += emitted_total
        self._occ_sum += len(active) / float(S)
        self._spec_rounds += 1
        self._spec_draft_s += draft_s
        self._spec_verify_s += verify_s
        self._spec_emitted += emitted_total
        self.counters['spec_propose_total'] += round_proposed
        self.counters['spec_accept_total'] += round_accepted
        self._blocks_peak = max(self._blocks_peak, self._alloc.in_use())
        self._set_occupancy()

    def _fail_residents(self, active, e):
        for i, st in active:
            self._release(i)
            st.req.fail(e)
        self._set_occupancy()

    def _finish_reason(self, st):
        c = self.config
        if c.eos_id is not None and st.last == c.eos_id:
            return 'eos'
        if st.generated >= st.req.max_new_tokens:
            return 'length'
        if st.pos >= c.max_len:
            # no cache row left for this token's K/V
            return 'cache_full'
        return None

    def _evict_expired(self):
        now = time.monotonic()
        for i, st in enumerate(self._slots):
            if st is not None and st.req.expired(now):
                self._release(i)
                st.req.fail(DeadlineExceededError(
                    "deadline passed mid-generation after %d tokens"
                    % st.generated))
        if self._pending_admit is not None and \
                self._pending_admit.expired(now):
            req, self._pending_admit = self._pending_admit, None
            req.fail(DeadlineExceededError(
                "deadline passed waiting for free KV blocks"))
        self._set_occupancy()

    @staticmethod
    def _fail_expired(expired):
        now = time.monotonic()
        for r in expired:
            r.fail(DeadlineExceededError(
                "deadline passed after %.3fs in queue"
                % (now - r.enqueue_t)))

    def _release_blocks(self, st):
        if st.blocks:
            self._alloc.deref_many(st.blocks)
            st.blocks = []
        if st.dblocks:
            self._draft_alloc.deref_many(st.dblocks)
            st.dblocks = []

    def _release(self, i):
        st = self._slots[i]
        if st is not None:
            self._release_blocks(st)
        self._slots[i] = None
        self._free.append(i)

    def _set_occupancy(self):
        n = sum(1 for s in self._slots if s is not None)
        self._occ_peak = max(self._occ_peak, n / float(len(self._slots)))
        self._active_peak = max(self._active_peak, n)

    # ------------------------------------------------------------------
    def stats(self):
        """Decode-loop statistics since construction. 'graphs' counts the
        bound signatures, the CUDA graphs captured (none on the CPU), their
        replays, and the signatures first bound after warmup() (0 when
        warmup bound every signature the traffic dispatched: the
        counterpart of the JAX engine's zero recompiles). Paged engines add
        the block accounting under 'blocks': the pool's state, the peak
        footprint and the prefix-cache entry count. Speculative engines add
        'spec': rounds, the tokens they emitted, proposed and accepted
        drafts, the accept rate, fallback steps, rounds that resynced a
        stale draft cache, the draft pool's blocks in use and the host
        seconds of the rounds' draft and verify legs (``draft_s``: issuing
        the drafter; ``verify_s``: issuing the verify step and waiting for
        both results)."""
        steps = self._decode_steps
        out = {
            'slots': self.config.slots,
            'active': sum(1 for s in self._slots if s is not None),
            'peak_active': self._active_peak,
            'queue_depth': self.queue.depth(),
            'decode_steps': steps,
            'decode_tokens': self._decode_tokens,
            'peak_slot_occupancy': round(self._occ_peak, 4),
            'mean_slot_occupancy': round(self._occ_sum / steps, 4)
            if steps else 0.0,
        }
        graphs = list(self._graphs.values())
        out['graphs'] = {
            'signatures': len(self._graphs),
            'captured': sum(1 for g in graphs if g.captured),
            'replays': sum(g.replays for g in graphs),
            'captures_after_warmup': self._late_binds,
        }
        if self.config.paged:
            out['blocks'] = {
                'block_size': self.config.block_size,
                'capacity': self._alloc.capacity,
                'in_use': self._alloc.in_use(),
                'free': self._alloc.available(),
                'peak_in_use': self._blocks_peak,
                'prefix_entries': len(self._prefix)
                if self._prefix is not None else 0,
            }
        if self.config.speculative:
            n = self.counters
            prop, acc = n['spec_propose_total'], n['spec_accept_total']
            out['spec'] = {
                'k': self.config.spec_k,
                'rounds': self._spec_rounds,
                'emitted': self._spec_emitted,
                'proposed': prop,
                'accepted': acc,
                'accept_rate': round(acc / float(prop), 4) if prop else 0.0,
                'fallbacks': n['spec_fallback_total'],
                'stale_draft_rounds': n['spec_stale_draft_rounds_total'],
                'draft_blocks_in_use': self._draft_alloc.in_use(),
                'draft_s': self._spec_draft_s,
                'verify_s': self._spec_verify_s,
            }
        return out
