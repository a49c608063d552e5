"""The decode engine's bound signatures (paddle_tpu_torch/serving/graphs.py)
on the CPU, where a `BoundStep` calls the model on the same static feed
buffers a CUDA graph reads on the card, at tests/test_torch_generate.py's
small LM (V 256, d 128, 2 heads, 2 layers).

- `prefill` and `prefill_paged` with the slot and the length as device
  tensors (0-d or [1] int64, the JAX programs' ``gen_slot`` / ``gen_len``
  feeds) equal their host-int forms bitwise, logits and cache, and match
  the JAX prefill programs within rtol / atol 1e-4 (f32 through two
  layers, summed in other orders).
- A `BoundStep` raises on a feed of another count, shape or dtype, and
  returns its static outputs.
- `warmup()` binds 2 + 2 * buckets signatures (the step and each bucket's
  prefill, greedy and sampled) in either cache mode, 2 more (drafter,
  verify) on a speculative engine and the draft's prefill buckets when
  the draft is not the target.
- Mixed traffic binds nothing after warmup (``captures_after_warmup`` 0,
  the counterpart of the JAX engine's zero recompiles) and its tokens
  equal `generate_once` and the JAX engine's; a signature missing at
  warmup is counted when the traffic binds it.
The card's side (graphs captured and replayed, launch counts, bitwise
equality with the eager step) is in tests/test_torch_cuda.py.
"""
import gc
import weakref

import numpy as np
import pytest
import torch

from paddle_tpu import goodput, monitor
from paddle_tpu.models.transformer import LMConfig as JLMConfig
from paddle_tpu.serving import GenerateConfig as JGenerateConfig
from paddle_tpu.serving import GenerateEngine as JGenerateEngine

from paddle_tpu_torch import monitor as tmonitor
from paddle_tpu_torch.models.transformer import LMConfig
from paddle_tpu_torch.serving import GenerateConfig, GenerateEngine
from paddle_tpu_torch.serving.graphs import BoundStep

V = 256
BUCKETS = [16, 32]
MAX_LEN = 64
SLOTS = 4
BS = 8
LM = dict(vocab_size=V, seq_len=32, d_model=128, n_head=2, n_layer=2,
          d_ff=256, dropout=0.0, attn_dropout=0.0)
SAMPLED = dict(temperature=0.8, top_k=30, top_p=0.9)


def _cfg(pkg=None, **kw):
    """A config of the port (``pkg`` None) or of the JAX package."""
    Config, Model = (JGenerateConfig, JLMConfig) if pkg == 'jax' else \
        (GenerateConfig, LMConfig)
    kw.setdefault('model', Model(**LM))
    for k, v in dict(slots=SLOTS, max_len=MAX_LEN,
                     prompt_buckets=list(BUCKETS), seed=3).items():
        kw.setdefault(k, v)
    return Config(**kw)


def _prompt(n, seed=0):
    return np.random.RandomState(seed).randint(2, V, size=n).astype('int64')


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope='module', autouse=True)
def _fresh_goodput_window():
    """The JAX engines arm the process-wide goodput sentinels; restart the
    window after this module (as tests/test_torch_generate.py does)."""
    yield
    goodput.reset()
    # the monitor keeps at most 64 series a metric: leave it empty
    monitor.reset()


@pytest.fixture(scope='module')
def jax_engines():
    """The JAX contiguous and paged engines on one scope (the paged engine
    re-zeroes the scope's cache to its geometry when it runs)."""
    contig = JGenerateEngine(_cfg('jax'))
    paged = JGenerateEngine(_cfg('jax', paged=True, block_size=BS),
                            scope=contig.scope)
    return contig, paged


@pytest.fixture(scope='module')
def params(jax_engines):
    s = jax_engines[0].scope
    return {n: np.asarray(s.get(n)) for n in s.names()
            if not n.startswith('gen_')}


def _jax_logits(j, b, feed):
    j._ensure_cache()           # the shared scope's cache in j's geometry
    prog, v = j._prefill[b]
    feed = dict(feed, **j._sample_feed(1))
    want, = j.executor.run(prog, feed=feed, fetch_list=[v['logits']],
                           scope=j.scope)
    return np.asarray(want)


def test_prefill_takes_device_slot_and_length(jax_engines, params):
    """Contiguous prefill of an 11-token prompt (bucket 16) into slot 2:
    host ints, [1] and 0-d tensors give the same bits in the logits, the
    first token and the cache; the logits match the JAX program's."""
    p = _prompt(11, 21)
    padded = np.zeros((1, 16), 'int64')
    padded[0, :p.size] = p
    eng = GenerateEngine(_cfg(), params=params, device='cpu')
    m = eng.model
    outs = []
    for slot, length in ((2, p.size), (_t([2]), _t([p.size])),
                         (_t(2), _t(p.size))):
        m.k_cache.zero_()
        m.v_cache.zero_()
        tok, logits = m.prefill(_t(padded), slot, length)
        outs.append((tok, logits, m.k_cache.clone(), m.v_cache.clone()))
    for got in outs[1:]:
        for a, b in zip(got, outs[0]):
            assert torch.equal(a, b)
    assert bool(outs[0][2][2].abs().sum() > 0)
    assert not bool(outs[0][2][[0, 1, 3]].abs().sum() > 0)
    want = _jax_logits(jax_engines[0], 16, {
        'gen_prompt': padded, 'gen_slot': np.array([[2]], 'int64'),
        'gen_len': np.array([[p.size]], 'int64')})
    np.testing.assert_allclose(outs[0][1].numpy(), want, rtol=1e-4,
                               atol=1e-4)


def test_prefill_paged_takes_device_length(jax_engines, params):
    """Paged prefill of a 13-token prompt into blocks 3 and 5 (bucket 16):
    a host-int, a [1] and a 0-d length give the same bits in the logits
    and the pool, pad rows only in the trash block; the logits match the
    JAX paged program's."""
    p = _prompt(13, 22)
    padded = np.zeros((1, 16), 'int64')
    padded[0, :p.size] = p
    table = np.zeros(MAX_LEN // BS, 'int64')
    table[:2] = [3, 5]
    pos = np.arange(16)
    eng = GenerateEngine(_cfg(paged=True, block_size=BS), params=params,
                         device='cpu')
    m = eng.model
    outs = []
    for length in (p.size, _t([p.size]), _t(p.size)):
        m.k_cache.zero_()
        m.v_cache.zero_()
        tok, logits = m.prefill_paged(_t(padded), _t(pos), _t(table), length)
        outs.append((tok, logits, m.k_cache.clone(), m.v_cache.clone()))
    for got in outs[1:]:
        for a, b in zip(got, outs[0]):
            assert torch.equal(a, b)
    live = outs[0][2][[3, 5]]
    assert bool(live[0].abs().sum() > 0)
    # rows 13..15 are pad: block 5 holds positions 8..12 only
    assert not bool(live[1][:, :, 5:].abs().sum() > 0)
    want = _jax_logits(jax_engines[1], 16, {
        'gen_prompt': padded, 'gen_pos': pos[None], 'gen_btab': table[None],
        'gen_len': np.array([[p.size]], 'int64')})
    np.testing.assert_allclose(outs[0][1].numpy(), want, rtol=1e-4,
                               atol=1e-4)


def test_bound_step_checks_its_feeds():
    """Exact shapes and dtypes, static outputs written by every call."""
    def fn(x, y):
        return x * 2, y.sum(0, keepdim=True)

    bs = BoundStep(fn, [((3,), 'int64'), ((2, 2), 'float32')], 'cpu',
                   name='probe')
    x = np.arange(3, dtype='int64')
    y = np.ones((2, 2), 'float32')
    a, b = bs(x, y)
    assert a.tolist() == [0, 2, 4] and b.tolist() == [[2.0, 2.0]]
    again = bs(x + 1, y * 3)
    assert again[0] is a and a.tolist() == [2, 4, 6]
    assert b.tolist() == [[6.0, 6.0]]
    assert bs.replays == 0 and not bs.captured
    for bad in ((x.astype('int32'), y), (x, y.astype('float64')),
                (x[:2], y), (x, y[None]), (x,), (x, y, y)):
        with pytest.raises(ValueError, match='probe'):
            bs(*bad)
    assert a.tolist() == [2, 4, 6]      # a refused call changes nothing


@pytest.mark.parametrize('kind,extra', [
    ('contiguous', 0), ('paged', 0), ('spec_target', 2),
    ('spec_draft_model', 2 + len(BUCKETS))])
def test_warmup_binds_every_signature(params, kind, extra):
    kw = {} if kind == 'contiguous' else dict(paged=True, block_size=BS)
    if kind.startswith('spec'):
        kw.update(speculative=True, spec_k=2)
    if kind == 'spec_draft_model':
        kw['draft_model'] = LMConfig(**dict(LM, n_layer=1))
    eng = GenerateEngine(_cfg(**kw), params=params, device='cpu')
    warm = eng.warmup()
    n = 2 + 2 * len(BUCKETS) + extra
    assert warm['signatures'] == n and warm['graphs'] == 0
    assert warm['buckets'] == len(BUCKETS)
    assert eng.stats()['graphs'] == {'signatures': n, 'captured': 0,
                                     'replays': 0,
                                     'captures_after_warmup': 0}
    assert not eng.model.cache_captured     # no graph on the CPU


def _work():
    """Greedy and sampled requests, one past the widest bucket in paged
    mode (a chunk), one sharing another's first 16 tokens (a prefix
    hit)."""
    base = _prompt(20, 40)
    prompts = [_prompt(5, 41), base, _prompt(30, 42),
               np.concatenate([base[:16], _prompt(6, 43)]), _prompt(12, 44)]
    return [(p, 6 + i, dict(SAMPLED, sample_seed=70 + i) if i % 2 else {})
            for i, p in enumerate(prompts)]


@pytest.mark.parametrize('paged', [False, True], ids=['contiguous', 'paged'])
def test_mixed_traffic_binds_nothing_after_warmup(jax_engines, params,
                                                  paged):
    kw = dict(paged=True, block_size=BS) if paged else {}
    work = _work()
    if paged:
        work.append((_prompt(40, 45), 5, {}))      # two prefill chunks
    eng = GenerateEngine(_cfg(**kw), params=params, device='cpu')
    eng.warmup()
    refs = [eng.generate_once(p, max_new_tokens=n, **s) for p, n, s in work]
    before = tmonitor.counters()
    with eng:
        outs = [list(r.result(60)) for r in
                [eng.submit(p, max_new_tokens=n, **s) for p, n, s in work]]
    assert outs == refs
    jeng = jax_engines[1] if paged else jax_engines[0]
    jeng.warmup()
    assert refs == [jeng.generate_once(p, max_new_tokens=n, **s)
                    for p, n, s in work]
    g = eng.stats()['graphs']
    assert g['captures_after_warmup'] == 0
    assert g['signatures'] == 2 + 2 * len(BUCKETS)
    if paged:
        assert tmonitor.counter_delta(before)[
            'kv_prefix_hit_total{outcome=hit}'] >= 1


def test_speculative_traffic_binds_nothing_after_warmup(params):
    """Greedy requests with a sampled rider (fallback steps, then rounds
    again): tokens equal the plain paged engine's generate_once, and no
    signature is bound after warmup; one dropped at warmup is bound by the
    traffic and counted."""
    plain = GenerateEngine(_cfg(paged=True, block_size=BS), params=params,
                           device='cpu')
    work = _work()
    refs = [plain.generate_once(p, max_new_tokens=n, **s)
            for p, n, s in work]
    for late in (None, ('verify',)):
        eng = GenerateEngine(_cfg(paged=True, block_size=BS,
                                  speculative=True, spec_k=2),
                             params=params, device='cpu')
        eng.warmup()
        if late:
            del eng._graphs[late]
        with eng:
            outs = [list(r.result(60)) for r in
                    [eng.submit(p, max_new_tokens=n, **s)
                     for p, n, s in work]]
        assert outs == refs
        st = eng.stats()
        assert st['spec']['rounds'] > 0 and st['spec']['fallbacks'] > 0
        assert st['graphs']['captures_after_warmup'] == (1 if late else 0)


def test_allocate_raises_once_a_graph_holds_the_cache(params):
    eng = GenerateEngine(_cfg(), params=params, device='cpu')
    eng.model.allocate_cache(2)             # no graph yet: allowed
    eng.model.cache_captured = True         # what a capture on the card sets
    for alloc in (lambda: eng.model.allocate_cache(SLOTS),
                  lambda: eng.model.allocate_paged_cache(8, BS)):
        with pytest.raises(RuntimeError, match='CUDA graph'):
            alloc()


@pytest.mark.parametrize('kw', [{}, dict(paged=True, block_size=BS,
                                         speculative=True, spec_k=2)],
                         ids=['contiguous', 'speculative'])
def test_an_engine_is_freed_without_a_cyclic_collection(params, kw):
    """Its bound steps hold the models, not the engine: once the last
    reference goes, a served engine (on the card: its graphs) is freed at
    once, not by a cyclic collection, which could land inside another
    engine's capture."""
    eng = GenerateEngine(_cfg(**kw), params=params, device='cpu')
    eng.warmup()
    with eng:
        eng.submit(_prompt(9, 50), max_new_tokens=4).result(60)
    ref = weakref.ref(eng)
    gc_on = gc.isenabled()
    gc.disable()
    try:
        del eng
        assert ref() is None
    finally:
        if gc_on:
            gc.enable()
