"""The paged decode engine: paddle_tpu_torch's paged KV cache, block pool,
prefix sharing, copy-on-write and chunked prefill against the JAX
package's, on the CPU, at the JAX tests' tiny shapes (V 64, d 32, 2 heads,
2 layers, max_len 48, block_size 8, buckets [8, 16]).

- Each paged op against its JAX op lowering in a one-op program: rtol /
  atol 1e-5 for the attentions (sums in another order), bitwise for the
  cache writes (no arithmetic), including the trash-block redirection of
  pad and invalid rows and masked rows of huge finite garbage that must
  contribute exactly 0.
- ``kv_blocks`` against the JAX module on one scripted sequence of calls:
  identical block ids, refcounts, hashes and evictions.
- The port's paged engine on the JAX engine's parameters against the JAX
  paged engine: identical greedy and pinned-seed sampled tokens (through
  prefix hits, copy-on-write and chunked prefill), `prefill_paged` and
  paged-step logits within rtol / atol 1e-4 (f32 through two layers,
  summed in other orders).
- The port's own contracts, mirroring tests/test_paged_generate.py and
  tests/test_speculative.py's chunked-prefill test, exact on the CPU.
"""
import numpy as np
import pytest
import torch

from paddle_tpu import goodput, monitor
from paddle_tpu.models.transformer import LMConfig as JLMConfig
from paddle_tpu.serving import GenerateConfig as JGenerateConfig
from paddle_tpu.serving import GenerateEngine as JGenerateEngine
from paddle_tpu.serving import kv_blocks as jkv_blocks

from paddle_tpu_torch import monitor as tmonitor
from paddle_tpu_torch.models.transformer import LMConfig
from paddle_tpu_torch.ops import kv_cache_ops
from paddle_tpu_torch.serving import (BlockAllocator, GenerateConfig,
                                      GenerateEngine, QuotaBlockAllocator,
                                      kv_blocks)

from test_torch_ops import _run_op

V = 64
BUCKETS = [8, 16]
MAX_LEN = 48
SLOTS = 4
BS = 8
NUM_BLOCKS = SLOTS * MAX_LEN // BS          # 24 physical = contiguous HBM
USABLE = NUM_BLOCKS - 1                     # block 0 is the trash block
LM = dict(vocab_size=V, seq_len=32, d_model=32, n_head=2, n_layer=2,
          d_ff=64, dropout=0.0, attn_dropout=0.0)
SAMPLED = dict(temperature=0.9, top_k=8, top_p=0.9)


def _cfg(**kw):
    kw.setdefault('model', LMConfig(use_flash_attention=False, **LM))
    kw.setdefault('slots', SLOTS)
    kw.setdefault('max_len', MAX_LEN)
    kw.setdefault('prompt_buckets', list(BUCKETS))
    kw.setdefault('paged', True)
    kw.setdefault('block_size', BS)
    return GenerateConfig(**kw)


def _prompt(n, seed=0):
    return np.random.RandomState(seed).randint(2, V, size=n).astype('int64')


def _drive(eng, *reqs):
    """Run the engine loop inline (no thread) until every given request
    finishes: allocator state is observable between token boundaries."""
    eng._admit()
    while any(r.finish_reason is None and r._error is None for r in reqs):
        eng._step()
        eng._evict_expired()
        eng._admit()


@pytest.fixture(scope='module', autouse=True)
def _fresh_goodput_window():
    """The JAX engine arms the process-wide goodput sentinels; restart the
    window after this module (as tests/test_torch_generate.py does)."""
    yield
    goodput.reset()
    # the monitor keeps at most 64 series a metric: leave it empty
    monitor.reset()


# ---------------------------------------------------------------------------
# paged ops vs the JAX op lowerings

NB, LN, H, DH, MB = 6, 2, 2, 4, 4           # blocks, layers, heads, dh


def _pool(rs):
    return rs.randn(NB, LN, H, BS, DH).astype('float32')


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_kv_cache_prefill_paged_matches_jax_and_trashes_pad_rows():
    rs = np.random.RandomState(1)
    cache, new = _pool(rs), rs.randn(1, H, 16, DH).astype('float32')
    table = np.array([[3, 5, 2, 0]], 'int64')
    pos = (5 + np.arange(16))[None].astype('int64')   # a 5-token prefix
    want = _run_op('kv_cache_prefill_paged',
                   {'Cache': cache, 'New': new, 'Positions': pos,
                    'BlockTable': table,
                    'Length': np.array([[11]], 'int64')},
                   'Out', {'layer': 1, 'block_size': BS})
    got = kv_cache_ops.kv_cache_prefill_paged(
        _t(cache.copy()), _t(new), _t(table[0]), _t(pos[0]), 11, 1, BS)
    real = cache.copy()
    for t in range(11):
        p = 5 + t
        real[table[0, p // BS], 1, :, p % BS] = new[0, :, t]
    # rows 11..15 are pad: they land in the trash block only
    np.testing.assert_array_equal(got.numpy()[1:], real[1:])
    np.testing.assert_array_equal(got.numpy()[1:], want[1:])
    np.testing.assert_array_equal(got.numpy()[0, 0], cache[0, 0])


@pytest.mark.parametrize('with_valid', [False, True])
def test_kv_cache_update_paged_matches_jax(with_valid):
    rs = np.random.RandomState(2)
    cache, new = _pool(rs), rs.randn(4, H, DH).astype('float32')
    tables = np.array([[3, 5, 0, 0], [2, 0, 0, 0], [0, 0, 0, 0],
                       [4, 2, 5, 1]], 'int64')
    # 40 // 8 = 5 clips to the table's last entry, live block 1
    pos = np.array([[9], [7], [0], [40]], 'int64')
    ins = {'Cache': cache, 'New': new, 'Positions': pos,
           'BlockTables': tables}
    valid = np.array([[1], [1], [1], [0]], 'int64')
    if with_valid:
        ins['Valid'] = valid
    want = _run_op('kv_cache_update_paged', ins, 'Out',
                   {'layer': 0, 'block_size': BS})
    c = _t(cache.copy())
    out = kv_cache_ops.kv_cache_update_paged(
        c, _t(new), _t(tables), _t(pos[:, 0]), 0, BS,
        valid=_t(valid[:, 0]) if with_valid else None)
    assert out is c                     # in place
    np.testing.assert_array_equal(c.numpy(), want)
    # the idle slot (all-zero table row) wrote to the trash block only;
    # an invalid row too, where the clipped lookup named live block 1
    np.testing.assert_array_equal(c.numpy()[1, 0, :, 0], new[3] if not
                                  with_valid else cache[1, 0, :, 0])


def test_kv_decode_attention_paged_matches_jax_and_zeroes_masked_rows():
    rs = np.random.RandomState(3)
    kc, vc = _pool(rs), _pool(rs)
    q = rs.randn(3, H, DH).astype('float32')
    tables = np.array([[3, 5, 0, 0], [2, 4, 1, 0], [0, 0, 0, 0]], 'int64')
    pos = np.array([[10], [20], [0]], 'int64')
    want = _run_op('kv_decode_attention_paged',
                   {'Q': q, 'KCache': kc, 'VCache': vc, 'Positions': pos,
                    'BlockTables': tables},
                   'Out', {'layer': 1, 'scale': DH ** -0.5,
                           'block_size': BS})
    args = (_t(tables), _t(pos[:, 0]), 1, DH ** -0.5)
    got = kv_cache_ops.kv_decode_attention_paged(_t(q), _t(kc), _t(vc),
                                                 *args)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # rows past each slot's position hold huge finite garbage: exact 0
    kc2, vc2 = kc.copy(), vc.copy()
    for s, p in ((0, 10), (1, 20)):
        for j in range(p + 1, MB * BS):
            b = tables[s, j // BS]
            if b:
                kc2[b, 1, :, j % BS] = 3e38
                vc2[b, 1, :, j % BS] = -3e38
    got2 = kv_cache_ops.kv_decode_attention_paged(_t(q), _t(kc2), _t(vc2),
                                                  *args)
    np.testing.assert_array_equal(got2.numpy()[:2], got.numpy()[:2])


def test_kv_prefix_attention_matches_jax_and_zeroes_masked_rows():
    rs = np.random.RandomState(4)
    kc, vc = _pool(rs), _pool(rs)
    q = rs.randn(1, H, 8, DH).astype('float32')
    table = np.array([[3, 5, 2, 0]], 'int64')
    pos = (8 + np.arange(8))[None].astype('int64')   # after an 8-prefix
    want = _run_op('kv_prefix_attention',
                   {'Q': q, 'KCache': kc, 'VCache': vc, 'Positions': pos,
                    'BlockTable': table},
                   'Out', {'layer': 0, 'scale': DH ** -0.5,
                           'block_size': BS})
    args = (_t(table[0]), _t(pos[0]), 0, DH ** -0.5)
    got = kv_cache_ops.kv_prefix_attention(_t(q), _t(kc), _t(vc), *args)
    assert tuple(got.shape) == (1, H, 8, DH)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    kc2, vc2 = kc.copy(), vc.copy()
    kc2[2, 0], vc2[2, 0] = 3e38, -3e38      # positions 16..23: all masked
    kc2[0, 0], vc2[0, 0] = 3e38, -3e38      # the trash block's rows
    got2 = kv_cache_ops.kv_prefix_attention(_t(q), _t(kc2), _t(vc2), *args)
    np.testing.assert_array_equal(got2.numpy(), got.numpy())


# ---------------------------------------------------------------------------
# kv_blocks vs the JAX module


def _script(mod):
    """One sequence of allocator, quota-view and prefix-cache calls; the
    trace of everything observable."""
    out = []
    alloc = mod.BlockAllocator(8, 4)
    out.append((alloc.capacity, alloc.available()))
    a = alloc.alloc(3)
    out += [a, alloc.alloc(5), alloc.in_use()]
    alloc.ref(a[0])
    out += [alloc.deref(a[0]), alloc.deref(a[0]), alloc.available()]
    for bad in (lambda: alloc.deref(a[0]), lambda: alloc.ref(0)):
        try:
            bad()
            out.append('no raise')
        except ValueError as e:
            out.append(str(e))
    toks = np.arange(13)
    h = mod.chain_hashes(toks, 4)
    out += [h, mod.chain_hashes(toks[:11], 4)]
    cache = mod.PrefixCache(alloc)
    b = alloc.alloc(3)
    out += [b] + [cache.register(x, i, y) for i, (x, y) in
                  enumerate(zip(h, b))] + [cache.register(h[0], 0, b[1])]
    out += [cache.match(h), cache.match(h[1:]), cache.match(h[:1] + [b'x'])]
    out.append([alloc.refcount(x) for x in range(8)])
    alloc.deref_many(b)
    cache.match(h[:1])                      # refreshes the first entry
    out += [alloc.available(), cache.evict_for(3), len(cache),
            alloc.available(), cache.match(h)]
    cache.drop_all()
    out += [len(cache), alloc.available(), list(alloc._free)]
    view = mod.QuotaBlockAllocator(alloc, 3, tenant='t')
    v = view.alloc(2)
    out += [v, view.alloc(2), view.available(), view.in_use()]
    view.ref(v[0])
    out += [view.in_use(), view.deref(v[0]), view.deref_many(v),
            view.in_use(), alloc.available()]
    return out


def test_kv_blocks_match_the_jax_module():
    assert _script(kv_blocks) == _script(jkv_blocks)


# ---------------------------------------------------------------------------
# the port's paged engine against the JAX paged engine


@pytest.fixture(scope='module')
def jax_engine():
    eng = JGenerateEngine(JGenerateConfig(
        model=JLMConfig(use_flash_attention=False, **LM), slots=SLOTS,
        max_len=MAX_LEN, prompt_buckets=list(BUCKETS), paged=True,
        block_size=BS, seed=3))
    eng.warmup()
    return eng


@pytest.fixture(scope='module')
def params(jax_engine):
    s = jax_engine.scope
    return {n: np.asarray(s.get(n)) for n in s.names()}


@pytest.fixture(scope='module')
def port_engine(params):
    return GenerateEngine(_cfg(), params=params, device='cpu')


# prompts of 2..5 blocks, two past the widest bucket (chunked prefill)
WORK = [(_prompt(5, 1), 9), (_prompt(16, 2), 7), (_prompt(21, 3), 12),
        (_prompt(40, 4), 6)]


@pytest.mark.parametrize('sampling', [
    {}, dict(temperature=0.8, sample_seed=11),
    dict(temperature=1.2, top_k=20, top_p=0.9, sample_seed=12)],
    ids=['greedy', 'temp', 'topk-topp'])
def test_generate_once_tokens_identical_to_jax(jax_engine, port_engine,
                                               sampling):
    for p, n in WORK:
        assert port_engine.generate_once(p, max_new_tokens=n, **sampling) \
            == jax_engine.generate_once(p, max_new_tokens=n, **sampling)
    assert port_engine._alloc.in_use() == 0


def test_prefill_paged_and_step_logits_match_jax(jax_engine, port_engine):
    """A prefill into blocks 3 and 5, a second prefill whose suffix
    attends the first's 8 cached rows (a prefix hit's shape), then one
    paged decode step: logits within 1e-4 of the JAX programs' on the same
    feeds."""
    j, m = jax_engine, port_engine.model
    p = _prompt(13, 21)
    table = np.zeros((1, MAX_LEN // BS), 'int64')
    table[0, :3] = [3, 5, 7]
    feeds = []
    for start, n, b in ((0, 13, 16), (8, 5, 8)):     # full, then suffix
        padded = np.zeros((1, b), 'int64')
        padded[0, :n] = p[start:start + n]
        feeds.append((padded, (start + np.arange(b))[None], n, b))
    for padded, pos, n, b in feeds:
        prog, v = j._prefill[b]
        feed = {'gen_prompt': padded, 'gen_pos': pos, 'gen_btab': table,
                'gen_len': np.array([[n]], 'int64')}
        feed.update(j._sample_feed(1))
        want, = j.executor.run(prog, feed=feed, fetch_list=[v['logits']],
                               scope=j.scope)
        first, got = m.prefill_paged(_t(padded), _t(pos[0]), _t(table[0]),
                                     n)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)
    toks = np.zeros((SLOTS, 1), 'int64')
    pos = np.zeros((SLOTS, 1), 'int64')
    btab = np.zeros((SLOTS, MAX_LEN // BS), 'int64')
    toks[2], pos[2], btab[2] = int(first[0]), 13, table[0]
    feed = {'gen_tokens': toks, 'gen_pos': pos, 'gen_btab': btab}
    feed.update(j._sample_feed(SLOTS))
    want, = j.executor.run(j._step_prog, feed=feed,
                           fetch_list=[j._step_vars['logits']],
                           scope=j.scope)
    _, got = m.decode_step(_t(toks[:, 0]), _t(pos[:, 0]), tables=_t(btab))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want)[2],
                               rtol=1e-4, atol=1e-4)


def test_shared_prefix_traffic_identical_to_jax(params):
    """Concurrent traffic with prefix hits, a copy-on-write pair of sampled
    sharers and a chunked prompt: every request's tokens and the
    prefix-cache counts equal the JAX engine's on the same weights."""
    from paddle_tpu import monitor
    shared = _prompt(16, 31)                # 2 full blocks
    work = [(shared, 6, {}),
            (np.concatenate([shared, _prompt(5, 32)]), 5, {}),
            (shared, 6, dict(SAMPLED, sample_seed=1)),
            (shared, 6, dict(SAMPLED, sample_seed=2)),
            (_prompt(37, 33), 4, {}), (_prompt(3, 34), 7, {})]
    # seed 3: the module engine's weights, which ``params`` holds
    jeng = JGenerateEngine(JGenerateConfig(
        model=JLMConfig(use_flash_attention=False, **LM), slots=SLOTS,
        max_len=MAX_LEN, prompt_buckets=list(BUCKETS), paged=True,
        block_size=BS, seed=3))
    np.testing.assert_array_equal(np.asarray(jeng.scope.get('lm_head.w')),
                                  params['lm_head.w'])
    eng = GenerateEngine(_cfg(), params=params, device='cpu')
    outs = {}
    before, tbefore = monitor.counters(), tmonitor.counters()
    for name, e in (('jax', jeng), ('port', eng)):
        e.warmup()
        first = e.submit(work[0][0], max_new_tokens=work[0][1])
        _drive(e, first)                    # registers the prefix blocks
        reqs = [first] + [e.submit(p, max_new_tokens=n, **kw)
                          for p, n, kw in work[1:]]
        _drive(e, *reqs)
        outs[name] = [list(r.result(5)) for r in reqs]
        e.stop()
    delta, tdelta = monitor.counter_delta(before), \
        tmonitor.counter_delta(tbefore)
    assert outs['port'] == outs['jax']
    assert outs['port'][2] != outs['port'][3]     # the sharers diverge
    for k in ('kv_block_cow_total', 'kv_prefix_hit_total{outcome=hit}',
              'kv_prefix_hit_total{outcome=miss}',
              'kv_prefix_tokens_saved_total'):
        assert tdelta.get(k, 0) == delta.get(k, 0), k
    assert tdelta['kv_block_cow_total'] == 2
    assert tdelta['kv_prefix_hit_total{outcome=hit}'] == 3
    assert tdelta['kv_prefix_tokens_saved_total'] == 16 + 15 + 15
    assert eng.stats()['blocks']['in_use'] == 0


# ---------------------------------------------------------------------------
# the port's own contracts (exact on the CPU)


def test_paged_equals_contiguous_flash_off_exactly(params):
    """Block-table decode equals the contiguous cache (flash off: the
    unfused prefill) token for token, solo and under concurrent traffic;
    finished requests return their blocks, stop() the prefix cache's."""
    contig = GenerateEngine(_cfg(paged=False), params=params, device='cpu')
    paged = GenerateEngine(_cfg(), params=params, device='cpu')
    work = [(_prompt(4, 1), 9), (_prompt(7, 2), 14), (_prompt(12, 3), 6),
            (_prompt(16, 4), 11), (_prompt(5, 5), 8), (_prompt(9, 6), 13)]
    refs = [contig.generate_once(p, max_new_tokens=n) for p, n in work]
    assert [paged.generate_once(p, max_new_tokens=n)
            for p, n in work] == refs
    with paged:
        outs = [r.result(60) for r in [paged.submit(p, max_new_tokens=n)
                                       for p, n in work]]
        live = paged.stats()['blocks']
        assert live['in_use'] == live['prefix_entries'] > 0
    assert [list(o) for o in outs] == refs
    assert paged.stats()['active'] == 0
    assert paged.stats()['blocks']['in_use'] == 0


def test_contiguous_flash_off_engine_matches_jax(params):
    """The contiguous engine with use_flash_attention=False (the unfused
    prefill: scores, the -1e9 upper-triangle mask, softmax, matmul) on the
    same weights as a JAX contiguous engine so configured: identical
    greedy tokens and first-token logits within 1e-4."""
    jeng = JGenerateEngine(JGenerateConfig(
        model=JLMConfig(use_flash_attention=False, **LM), slots=SLOTS,
        max_len=MAX_LEN, prompt_buckets=list(BUCKETS), seed=3))
    jeng.warmup()
    eng = GenerateEngine(_cfg(paged=False), params=params, device='cpu')
    for p, n in WORK[:2] + [(_prompt(11, 7), 10)]:
        assert eng.generate_once(p, max_new_tokens=n) == \
            jeng.generate_once(p, max_new_tokens=n)
    p = _prompt(11, 22)
    padded = np.zeros((1, 16), 'int64')
    padded[0, :11] = p
    prog, v = jeng._prefill[16]
    feed = {'gen_prompt': padded, 'gen_slot': np.array([[1]], 'int64'),
            'gen_len': np.array([[11]], 'int64')}
    feed.update(jeng._sample_feed(1))
    want, = jeng.executor.run(prog, feed=feed, fetch_list=[v['logits']],
                              scope=jeng.scope)
    _, got = eng.model.prefill(_t(padded), 1, 11)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_prefix_blocks_are_reused_by_refcount(params):
    eng = GenerateEngine(_cfg(prompt_buckets=[8, 16, 32]), params=params,
                         device='cpu')
    p = _prompt(20, 21)
    before = tmonitor.counters()
    a = eng.submit(p, max_new_tokens=3)
    _drive(eng, a)
    assert tmonitor.counter_delta(before)[
        'kv_prefix_hit_total{outcome=miss}'] == 1
    assert eng.stats()['blocks']['prefix_entries'] == 2
    reg = [e[0] for e in sorted(eng._prefix._entries.values(),
                                key=lambda e: e[1])]
    b = eng.submit(p, max_new_tokens=3)
    eng._admit()
    st = next(s for s in eng._slots if s is not None)
    assert st.blocks[:2] == reg             # the same physical blocks
    assert eng._alloc.refcount(reg[0]) == 2     # cache + b
    assert list(st.table[:3]) == st.blocks
    _drive(eng, b)
    delta = tmonitor.counter_delta(before)
    assert delta['kv_prefix_hit_total{outcome=hit}'] == 1
    assert delta['kv_prefix_tokens_saved_total'] == 16
    assert delta.get('kv_block_cow_total', 0) == 0
    assert b.result(5) == a.result(5)
    eng.stop()
    assert eng._alloc.in_use() == 0


def test_cow_isolates_two_sampled_sharers(params):
    eng = GenerateEngine(_cfg(), params=params, device='cpu')
    p = _prompt(16, 31)                     # 2 full blocks, no partial
    kw = dict(SAMPLED, max_new_tokens=6)
    ref_a = eng.generate_once(p, sample_seed=1, **kw)
    ref_b = eng.generate_once(p, sample_seed=2, **kw)
    assert ref_a != ref_b
    greedy = eng.generate_once(p, max_new_tokens=6)
    before = tmonitor.counters()
    with eng:
        assert eng.submit(p, max_new_tokens=6).result(60) == greedy
        ra = eng.submit(p, sample_seed=1, **kw)
        rb = eng.submit(p, sample_seed=2, **kw)
        assert ra.result(60) == ref_a
        assert rb.result(60) == ref_b
    delta = tmonitor.counter_delta(before)
    assert delta['kv_block_cow_total'] >= 2
    assert delta['kv_prefix_hit_total{outcome=hit}'] >= 2


def test_exhaustion_finishes_cache_full_and_returns_every_block(params):
    """Four growers need 4 * 6 = 24 blocks of a 23-block pool: one starves
    at its last block crossing and finishes 'cache_full' early; the others
    decode to the cache's end; every block returns."""
    eng = GenerateEngine(_cfg(prefix_sharing=False), params=params,
                         device='cpu')
    assert eng._alloc.capacity == USABLE
    reqs = [eng.submit(_prompt(16, 50 + i), max_new_tokens=40)
            for i in range(4)]
    _drive(eng, *reqs)
    assert all(r.finish_reason == 'cache_full' for r in reqs)
    assert sorted(len(r.result(5)) for r in reqs) == [25, 33, 33, 33]
    assert eng._alloc.in_use() == 0 and eng._alloc.available() == USABLE
    with pytest.raises(ValueError, match='max_len - 1'):
        eng.submit(_prompt(MAX_LEN, 1))
    eng.stop()


def test_paged_holds_2x_the_sequences_at_the_same_hbm(params):
    contiguous_slots_at_budget = NUM_BLOCKS * BS // MAX_LEN   # = SLOTS
    eng = GenerateEngine(_cfg(slots=4 * SLOTS, num_blocks=NUM_BLOCKS),
                         params=params, device='cpu')
    work = [(_prompt(3 + i % 3, 60 + i), 3) for i in range(16)]
    refs = [eng.generate_once(p, max_new_tokens=n) for p, n in work]
    reqs = [eng.submit(p, max_new_tokens=n) for p, n in work]
    eng._admit()
    st = eng.stats()
    assert st['active'] == 16 and st['blocks']['in_use'] <= USABLE
    _drive(eng, *reqs)
    assert [r.result(5) for r in reqs] == refs
    assert eng.stats()['peak_active'] >= 2 * contiguous_slots_at_budget
    eng.stop()


def test_matched_blocks_are_pinned_against_pressure_eviction(params):
    """With the rest of the pool hoarded, planning an admission must not
    evict the blocks its prefix match returned and recycle one as fresh:
    the plan parks, and proceeds once blocks free up."""
    eng = GenerateEngine(_cfg(), params=params, device='cpu')
    p = _prompt(16, 91)
    a = eng.submit(p, max_new_tokens=3)
    _drive(eng, a)
    reg = sorted(e[0] for e in eng._prefix._entries.values())
    hoard = eng._alloc.alloc(eng._alloc.available())
    b = eng.submit(p, max_new_tokens=3)
    eng._admit()
    assert eng._pending_admit is b
    assert sorted(e[0] for e in eng._prefix._entries.values()) == reg
    eng._alloc.deref_many(hoard)
    _drive(eng, b)
    assert b.result(5) == a.result(5)
    assert eng._alloc.in_use() == len(eng._prefix._entries)
    eng.stop()


def test_chunked_prefill_equals_single_shot(params):
    """A prompt past the widest bucket prefills in chunks; its tokens equal
    a single-shot prefill through a 40-wide bucket, through generate_once
    and the engine loop. Contiguous engines keep the ladder bound."""
    p = _prompt(40, 9)
    ref = GenerateEngine(_cfg(prompt_buckets=[40]), params=params,
                         device='cpu').generate_once(p, max_new_tokens=8)
    eng = GenerateEngine(_cfg(), params=params, device='cpu')
    assert eng.generate_once(p, max_new_tokens=8) == ref
    with eng:
        assert list(eng.submit(p, max_new_tokens=8).result(60)) == ref
    contig = GenerateEngine(_cfg(paged=False), params=params, device='cpu')
    with pytest.raises(ValueError, match='largest prompt bucket'):
        contig.submit(_prompt(BUCKETS[-1] + 1, 11))


def test_config_checks_and_allocator_injection(params):
    with pytest.raises(ValueError, match='divisible'):
        _cfg(block_size=10)
    with pytest.raises(ValueError, match='num_blocks'):
        _cfg(num_blocks=1)
    assert _cfg().num_blocks == NUM_BLOCKS
    assert _cfg(paged=False).num_blocks is None
    assert not _cfg(paged=False).prefix_sharing
    with pytest.raises(ValueError, match='paged=True'):
        GenerateEngine(_cfg(paged=False), params=params, device='cpu',
                       block_allocator=BlockAllocator(8, BS))
    with pytest.raises(ValueError, match='block_size'):
        GenerateEngine(_cfg(), params=params, device='cpu',
                       block_allocator=BlockAllocator(8, 4))
    with pytest.raises(ValueError, match='25 blocks'):
        GenerateEngine(_cfg(), params=params, device='cpu',
                       block_allocator=QuotaBlockAllocator(
                           BlockAllocator(NUM_BLOCKS + 1, BS), 6))
    pool = BlockAllocator(NUM_BLOCKS, BS)
    view = QuotaBlockAllocator(pool, 6, tenant='a')
    eng = GenerateEngine(_cfg(), params=params, device='cpu',
                         block_allocator=view)
    assert eng.stats()['blocks']['capacity'] == 6
    p = _prompt(12, 5)
    r = eng.submit(p, max_new_tokens=4)
    _drive(eng, r)
    assert r.result(5) == eng.generate_once(p, max_new_tokens=4)
    assert view.in_use() == pool.in_use() == 1    # the cached prefix block
    eng.stop()
    assert pool.in_use() == 0
