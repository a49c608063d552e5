"""Speculative decoding on the paged engine: paddle_tpu_torch's drafter,
verify step, span ops and the engine's speculative mode against the JAX
package's, on the CPU, at tests/test_speculative.py's tiny shapes (V 64,
d 32, 2 heads, 2 layers, max_len 48, block_size 8, buckets [8, 16], 4
slots, spec_k 2).

- The span write against its JAX op lowering bitwise (no arithmetic),
  rows with ``valid == 0`` in the trash block included; the verify
  attention within rtol / atol 1e-5 (sums in another order), masked rows
  of huge finite garbage giving exactly 0.
- `TransformerLM.draft_steps` against the JAX drafter program on the same
  parameters and caches: identical drafts, written K/V within 1e-4.
  `TransformerLM.verify_step` against the JAX verify program: logits
  within 1e-4; and against the port's own `decode_step` at each row's
  position: logits exactly equal (the acceptance oracle is bitwise on the
  CPU).
- The engine contracts of tests/test_speculative.py on the JAX engine's
  parameters: tokens equal to the plain paged engine's and to the JAX
  speculative engine's, exactly; driven round by round, the same rounds,
  proposals and acceptances as the JAX engine, and the truncation
  invariant after every round.
"""
import numpy as np
import pytest
import torch

from paddle_tpu import goodput
from paddle_tpu.executor import Scope
from paddle_tpu.models.transformer import KV_CACHE_K, KV_CACHE_V
from paddle_tpu.models.transformer import LMConfig as JLMConfig
from paddle_tpu.serving import GenerateConfig as JGenerateConfig
from paddle_tpu.serving import GenerateEngine as JGenerateEngine

from paddle_tpu_torch.io import params_from_numpy
from paddle_tpu_torch.models.transformer import LMConfig
from paddle_tpu_torch.ops import kv_cache_ops
from paddle_tpu_torch.serving import GenerateConfig, GenerateEngine

from test_torch_ops import _run_op

V = 64
BUCKETS = [8, 16]
MAX_LEN = 48
SLOTS = 4
BS = 8
K = 2
W = K + 1
MB = MAX_LEN // BS
LM = dict(vocab_size=V, seq_len=32, d_model=32, n_head=2, n_layer=2,
          d_ff=64, dropout=0.0, attn_dropout=0.0, use_flash_attention=False)
# the layer-skip draft's parameters: the target's embedding, first layer,
# final LayerNorm and head
SKIP = ('tok_emb.w', 'final_ln.w', 'final_ln.b', 'lm_head.w')


def _cfg(pkg=None, **kw):
    """A config of the port (``pkg`` None) or of the JAX package."""
    Config, Model = (JGenerateConfig, JLMConfig) if pkg == 'jax' else \
        (GenerateConfig, LMConfig)
    kw.setdefault('model', Model(**LM))
    if kw.get('draft_model') == 'one_layer':
        kw['draft_model'] = Model(**dict(LM, n_layer=1))
    for k, v in dict(slots=SLOTS, max_len=MAX_LEN, paged=True,
                     prompt_buckets=list(BUCKETS), block_size=BS,
                     seed=3).items():
        kw.setdefault(k, v)
    return Config(**kw)


def _spec(pkg=None, **kw):
    kw.setdefault('speculative', True)
    kw.setdefault('spec_k', K)
    return _cfg(pkg, **kw)


def _prompt(n, seed=0):
    return np.random.RandomState(seed).randint(2, V, size=n).astype('int64')


WORK = [(_prompt(4, 1), 9), (_prompt(7, 2), 14), (_prompt(12, 3), 6),
        (_prompt(16, 4), 11)]


def _drive(eng, *reqs, each_round=None):
    """Run the engine loop inline (no thread) until every given request
    finishes, calling ``each_round(eng)`` after every step."""
    eng._admit()
    while any(r.finish_reason is None and r._error is None for r in reqs):
        eng._step()
        if each_round is not None:
            each_round(eng)
        eng._evict_expired()
        eng._admit()


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope='module', autouse=True)
def _fresh_goodput_window():
    """The JAX engines arm the process-wide goodput sentinels; restart the
    window after this module (as tests/test_torch_paged.py does)."""
    yield
    goodput.reset()


@pytest.fixture(scope='module')
def jax_spec():
    """The JAX speculative engine, drafting with the target's weights (the
    seed-3 weights of tests/test_torch_paged.py's engine)."""
    eng = JGenerateEngine(_spec('jax'))
    eng.warmup()
    return eng


@pytest.fixture(scope='module')
def params(jax_spec):
    s = jax_spec.scope
    return {n: np.asarray(s.get(n)) for n in s.names()}


@pytest.fixture(scope='module')
def refs(params):
    plain = GenerateEngine(_cfg(), params=params, device='cpu')
    return [plain.generate_once(p, max_new_tokens=n) for p, n in WORK]


def _jax_draft_engine(jax_spec, draft):
    """A JAX speculative engine on ``jax_spec``'s weights with the draft
    named by ``draft``: 'target', 'one_layer' (a fresh one-layer model from
    the seed) or 'layer_skip' (the target's first layer, aliased)."""
    if draft == 'target':
        return JGenerateEngine(_spec('jax'), scope=jax_spec.scope)
    if draft == 'one_layer':
        return JGenerateEngine(_spec('jax', draft_model='one_layer'),
                               scope=jax_spec.scope)
    ds = Scope()
    for name in jax_spec.scope.names():
        if name.startswith('layer_0.') or name in SKIP:
            ds.set(name, jax_spec.scope.get(name))
    return JGenerateEngine(_spec('jax', draft_model='one_layer'),
                           scope=jax_spec.scope, draft_scope=ds)


def _port_draft_engine(params, draft, jeng, **kw):
    """The port's counterpart of `_jax_draft_engine` (``jeng`` is it: the
    fresh one-layer draft takes its draft scope's weights)."""
    if draft == 'target':
        return GenerateEngine(_spec(**kw), params=params, device='cpu')
    if draft == 'one_layer':
        return GenerateEngine(
            _spec(draft_model='one_layer', **kw), params=params,
            draft_params={n: np.asarray(jeng._draft_scope.get(n))
                          for n in jeng._draft_scope.names()},
            device='cpu')
    target = params_from_numpy(params, 'cpu')
    return GenerateEngine(
        _spec(draft_model='one_layer', **kw), params=target,
        draft_params={n: t for n, t in target.items()
                      if n.startswith('layer_0.') or n in SKIP},
        device='cpu')


# ---------------------------------------------------------------------------
# the span ops vs the JAX op lowerings

NB, LN, H, DH = 6, 2, 2, 4


def _pool(rs):
    return rs.randn(NB, LN, H, BS, DH).astype('float32')


def test_kv_cache_update_span_paged_matches_jax_bitwise():
    rs = np.random.RandomState(5)
    cache, new = _pool(rs), rs.randn(3, H, W, DH).astype('float32')
    tables = np.array([[3, 5, 0, 0], [2, 4, 0, 1], [0, 0, 0, 0]], 'int64')
    # slot 0 crosses from block 3 into 5; slot 1's last row lies past the
    # table (the clipped lookup would name live block 1) and is invalid;
    # slot 2 is idle
    pos = np.array([[6, 7, 8], [13, 14, 40], [0, 1, 2]], 'int64')
    valid = np.array([[1, 1, 1], [1, 1, 0], [0, 0, 0]], 'int64')
    want = _run_op('kv_cache_update_span_paged',
                   {'Cache': cache, 'New': new, 'Positions': pos,
                    'BlockTables': tables, 'Valid': valid},
                   'Out', {'layer': 1, 'block_size': BS})
    c = _t(cache.copy())
    out = kv_cache_ops.kv_cache_update_span_paged(
        c, _t(new), _t(tables), _t(pos), _t(valid), 1, BS)
    assert out is c                                 # in place
    np.testing.assert_array_equal(c.numpy(), want)
    real = cache.copy()
    for s in range(3):
        for t in range(W):
            if valid[s, t]:
                p = pos[s, t]
                real[tables[s, p // BS], 1, :, p % BS] = new[s, :, t]
    # every live block holds exactly the valid rows; the invalid and idle
    # rows went to the trash block only
    np.testing.assert_array_equal(c.numpy()[1:], real[1:])
    np.testing.assert_array_equal(c.numpy()[1, 1], cache[1, 1])


def test_kv_verify_attention_paged_matches_jax_and_zeroes_masked_rows():
    rs = np.random.RandomState(6)
    kc, vc = _pool(rs), _pool(rs)
    q = rs.randn(3, H, W, DH).astype('float32')
    tables = np.array([[3, 5, 0, 0], [2, 4, 1, 0], [0, 0, 0, 0]], 'int64')
    pos = np.array([[9, 10, 11], [18, 19, 20], [0, 1, 2]], 'int64')
    want = _run_op('kv_verify_attention_paged',
                   {'Q': q, 'KCache': kc, 'VCache': vc, 'Positions': pos,
                    'BlockTables': tables},
                   'Out', {'layer': 1, 'scale': DH ** -0.5,
                           'block_size': BS})
    args = (_t(tables), _t(pos), 1, DH ** -0.5)
    got = kv_cache_ops.kv_verify_attention_paged(_t(q), _t(kc), _t(vc),
                                                 *args)
    assert tuple(got.shape) == (3, H, W, DH)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # rows past each slot's last window position hold huge finite
    # garbage, the trash block too: exact 0
    kc2, vc2 = kc.copy(), vc.copy()
    for s, p in ((0, 11), (1, 20)):
        for j in range(p + 1, tables.shape[1] * BS):
            b = tables[s, j // BS]
            if b:
                kc2[b, 1, :, j % BS] = 3e38
                vc2[b, 1, :, j % BS] = -3e38
    kc2[0, 1], vc2[0, 1] = 3e38, -3e38
    got2 = kv_cache_ops.kv_verify_attention_paged(_t(q), _t(kc2), _t(vc2),
                                                  *args)
    np.testing.assert_array_equal(got2.numpy()[:2], got.numpy()[:2])


# ---------------------------------------------------------------------------
# the drafter and the verify step against the JAX programs


def _caches(rs, nb, cfg):
    """Random K and V pools for ``nb`` blocks of the model ``cfg``."""
    shape = (nb, cfg['n_layer'], cfg['n_head'], BS,
             cfg['d_model'] // cfg['n_head'])
    return [rs.randn(*shape).astype('float32') for _ in range(2)]


def _window_feeds(last=MAX_LEN - 2):
    """Slots 0, 1 and 3 live (slot 3 at position ``last``: by default one
    row from max_len, so its later rows are out of budget), slot 2
    idle."""
    toks = np.array([11, 40, 0, 7], 'int64')
    pos = np.array([13, 30, 0, last], 'int64')
    tables = np.zeros((SLOTS, MB), 'int64')
    tables[0, :3] = [3, 5, 7]
    tables[1, :5] = [2, 4, 6, 8, 9]
    tables[3] = [10, 11, 12, 13, 14, 15]
    return toks, pos, tables


def test_draft_steps_match_the_jax_drafter(jax_spec, params):
    """Slot 3's window ends at max_len - 1 here. (At or past max_len the
    JAX drafter's position gather, ``jnp.take``, fills the row with NaN;
    its write lands in the trash block, which every slot's attention
    gathers, and 0 * NaN spreads it to the other slots' rows. The next
    test holds the port at that edge on its own.)"""
    j = jax_spec
    rs = np.random.RandomState(7)
    kc, vc = _caches(rs, j._draft_nb, LM)
    toks, pos, tables = _window_feeds(MAX_LEN - 3)
    vmask = np.ones((SLOTS, W), 'int64')
    vmask[2] = 0
    j._draft_scope.set(KV_CACHE_K, kc.copy())
    j._draft_scope.set(KV_CACHE_V, vc.copy())
    want, = j.executor.run(
        j._drafter_prog, feed={'gen_tokens': toks[:, None],
                               'gen_pos': pos[:, None], 'gen_btab': tables,
                               'gen_vmask': vmask},
        fetch_list=[j._drafter_vars['draft_tokens']], scope=j._draft_scope)
    eng = GenerateEngine(_spec(), params=params, device='cpu')
    d = eng.draft
    d.k_cache.copy_(_t(kc))
    d.v_cache.copy_(_t(vc))
    got = d.draft_steps(_t(toks), _t(pos), _t(tables), _t(vmask), K)
    assert tuple(got.shape) == (SLOTS, K)
    live = [0, 1, 3]
    np.testing.assert_array_equal(got.numpy()[live], np.asarray(want)[live])
    # the K/V the K + 1 towers wrote into live blocks, the write-only
    # tower's included (the trash block's rows are garbage by design)
    for name, cache in ((KV_CACHE_K, d.k_cache), (KV_CACHE_V, d.v_cache)):
        np.testing.assert_allclose(cache.numpy()[1:],
                                   np.asarray(j._draft_scope.get(name))[1:],
                                   rtol=1e-4, atol=1e-4)
    # the trailing write-only tower deposited the K-th draft's K/V at pos
    # + K (slot 0: position 15, block 5)
    assert not np.array_equal(d.k_cache.numpy()[5, :, :, 15 % BS],
                              kc[5, :, :, 15 % BS])


def test_draft_steps_past_max_len_read_the_last_position_row(params):
    """A slot whose window runs past max_len: its steps there read the
    position table's last row (the reference's clipping gather), its
    writes there go to the trash block, and the other slots' drafts and
    cache rows are those of a run without it."""
    rs = np.random.RandomState(9)
    eng = GenerateEngine(_spec(), params=params, device='cpu')
    d = eng.draft
    kc, vc = (_t(a) for a in _caches(rs, eng._draft_alloc.num_blocks, LM))
    toks, pos, tables = _window_feeds()
    vmask = np.ones((SLOTS, W), 'int64')
    vmask[2] = 0
    out = {}
    for name, last in (('at_max_len', True), ('idle', False)):
        d.k_cache.copy_(kc)
        d.v_cache.copy_(vc)
        vm, tab = vmask.copy(), tables.copy()
        if last:
            vm[3, 2:] = 0                       # pos + 2 == max_len
        else:
            vm[3], tab[3] = 0, 0
        drafts = d.draft_steps(_t(toks), _t(pos), _t(tab), _t(vm), K)
        out[name] = (drafts, d.k_cache[1:].clone(), d.v_cache[1:].clone())
    a, b = out['at_max_len'], out['idle']
    assert torch.equal(a[0][[0, 1]], b[0][[0, 1]])
    assert all(torch.isfinite(t).all() for t in a[1:])
    # only slot 3's own blocks differ between the two runs
    for x, y in zip(a[1:], b[1:]):
        diff = (x != y).flatten(1).any(1).nonzero().flatten() + 1
        assert set(diff.tolist()) <= set(tables[3].tolist())


def test_verify_step_matches_jax_and_the_decode_step_exactly(jax_spec,
                                                             params):
    j = jax_spec
    rs = np.random.RandomState(8)
    kc, vc = _caches(rs, _cfg().num_blocks, LM)
    toks, pos, tables = _window_feeds()
    vt = np.concatenate([toks[:, None], rs.randint(2, V, (SLOTS, K))], 1)
    vp = np.clip(pos[:, None] + np.arange(W), 0, MAX_LEN - 1)
    vv = np.ones((SLOTS, W), 'int64')
    vv[2] = 0
    vv[3, 2:] = 0
    j.scope.set(KV_CACHE_K, kc.copy())
    j.scope.set(KV_CACHE_V, vc.copy())
    want, = j.executor.run(
        j._verify_prog, feed={'gen_tokens': vt, 'gen_pos': vp,
                              'gen_btab': tables, 'gen_vmask': vv},
        fetch_list=[j._verify_vars['logits']], scope=j.scope)
    m = GenerateEngine(_cfg(), params=params, device='cpu').model
    m.k_cache.copy_(_t(kc))
    m.v_cache.copy_(_t(vc))
    nxt, got = m.verify_step(_t(vt), _t(vp), _t(tables), _t(vv))
    assert tuple(got.shape) == (SLOTS * W, V)
    rows = [s * W + t for s in (0, 1, 3) for t in range(W)]
    np.testing.assert_allclose(got.numpy()[rows], np.asarray(want)[rows],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(nxt.numpy(), got.numpy().argmax(1))
    # row t of each live slot equals the one-token step at its position
    # (the step attends the rows the verify step deposited before t)
    live = np.array([1, 1, 0, 1])
    for t in range(W):
        if t == 2:
            live[3] = 0                         # out of budget at max_len
        btab = tables * live[:, None]
        _, step = m.decode_step(_t(vt[:, t]), _t(vp[:, t] * live),
                                tables=_t(btab))
        for s in np.flatnonzero(live):
            assert torch.equal(step[s], got[s * W + t]), (s, t)


# ---------------------------------------------------------------------------
# the engine's contracts


@pytest.mark.parametrize('draft', ['target', 'one_layer', 'layer_skip'])
def test_round_by_round_matches_jax_and_truncates(jax_spec, params, refs,
                                                  draft):
    """Both engines driven round by round on the same traffic: the same
    tokens as the plain engine, the same rounds, proposals and
    acceptances as the JAX engine, and after every round each slot holds
    the blocks of its accepted positions and at most its next write's
    block, in both pools."""
    jeng = _jax_draft_engine(jax_spec, draft)
    eng = _port_draft_engine(params, draft, jeng)
    if draft != 'one_layer':
        # the draft aliases the target's tensors, it does not copy them
        names = ['lm_head.w', 'layer_0.ffn1.w'] + (
            ['layer_1.ffn1.w'] if draft == 'target' else [])
        for n in names:
            assert eng.draft.p[n].data_ptr() == eng.model.p[n].data_ptr()

    def invariant(e):
        for st in e._slots:
            if st is None:
                continue
            # every accepted position's block is held, and nothing past the
            # next write's block (which the next growth adds if missing)
            keep = min(MB, st.pos // BS + 1)
            assert -(-st.pos // BS) <= len(st.blocks) <= keep
            # a plain step (no proposal fit the budget) grows the target's
            # table only; a speculative round leaves both tables alike
            assert len(st.dblocks) <= len(st.blocks) if st.draft_stale \
                else len(st.dblocks) == len(st.blocks)

    counts = {}
    for name, e in (('jax', jeng), ('port', eng)):
        e.warmup()
        reqs = [e.submit(p, max_new_tokens=n) for p, n in WORK]
        _drive(e, *reqs, each_round=invariant)
        assert [list(r.result(5)) for r in reqs] == refs
        assert e._draft_alloc.in_use() == 0
        e.stop()
        counts[name] = {k: e.stats()['spec'][k]
                        for k in ('rounds', 'proposed', 'accepted')}
    assert counts['port'] == counts['jax']
    rate = eng.stats()['spec']['accept_rate']
    assert rate == 1.0 if draft == 'target' else rate < 1.0
    assert eng.stats()['blocks']['in_use'] == 0


def test_accept_path_threaded(params, refs, jax_spec):
    """The started engine with the target's own weights as the draft:
    tokens equal to the plain and the JAX speculative engines', accept
    rate exactly 1.0, far fewer rounds than tokens, both pools drained,
    the request's timing and the counters filled in."""
    with jax_spec:
        jouts = [list(jax_spec.submit(p, max_new_tokens=n).result(60))
                 for p, n in WORK]
    spec = GenerateEngine(_spec(), params=params, device='cpu')
    spec.warmup()
    with spec:
        reqs = [spec.submit(p, max_new_tokens=n) for p, n in WORK]
        outs = [list(r.result(60)) for r in reqs]
    assert outs == refs == jouts
    st = spec.stats()
    assert st['spec']['accept_rate'] == 1.0 and st['spec']['rounds'] > 0
    assert st['decode_steps'] < st['decode_tokens'] / 2
    assert st['spec']['draft_blocks_in_use'] == 0
    assert st['blocks']['in_use'] == 0
    t = reqs[0].timing
    assert t['spec_accept_rate'] == 1.0 and t['spec_proposed'] > 0
    assert t['draft_s'] > 0 and t['verify_s'] > 0
    n = spec.counters
    assert n['spec_propose_total'] == st['spec']['proposed'] == \
        n['spec_accept_total'] > 0
    assert n['spec_fallback_total'] == 0


def test_eos_inside_the_window(jax_spec, params):
    """An eos in mid-window ends the request where plain decoding
    does."""
    eos = int(GenerateEngine(_cfg(), params=params, device='cpu')
              .generate_once(WORK[1][0], max_new_tokens=14)[7])
    plain = GenerateEngine(_cfg(eos_id=eos), params=params, device='cpu')
    refs = [plain.generate_once(p, max_new_tokens=n) for p, n in WORK]
    assert any(r[-1] == eos and len(r) < n for r, (_, n) in
               zip(refs, WORK)), 'the eos token ends no reference'
    jeng = JGenerateEngine(_spec('jax', eos_id=eos), scope=jax_spec.scope)
    outs = {}
    for name, e in (('jax', jeng), ('port', GenerateEngine(
            _spec(eos_id=eos), params=params, device='cpu'))):
        e.warmup()
        reqs = [e.submit(p, max_new_tokens=n) for p, n in WORK]
        _drive(e, *reqs)
        outs[name] = [list(r.result(5)) for r in reqs]
        e.stop()
    assert outs['port'] == outs['jax'] == refs


def test_sampled_rider_falls_back(jax_spec, params):
    """A sampled resident takes the batch onto plain steps
    (``spec_fallback_total``); greedy and sampled tokens equal their solo
    references and the JAX engine's."""
    pg, ps = _prompt(6, 31), _prompt(9, 32)
    smp = dict(temperature=0.8, top_k=8, sample_seed=11)
    outs = {}
    for name, e in (('jax', JGenerateEngine(_spec('jax'),
                                            scope=jax_spec.scope)),
                    ('port', GenerateEngine(_spec(), params=params,
                                            device='cpu'))):
        ref = [e.generate_once(pg, max_new_tokens=8),
               e.generate_once(ps, max_new_tokens=8, **smp)]
        reqs = [e.submit(pg, max_new_tokens=8),
                e.submit(ps, max_new_tokens=8, **smp)]
        _drive(e, *reqs)
        outs[name] = [list(r.result(5)) for r in reqs]
        assert outs[name] == ref
        e.stop()
        assert e.stats()['spec'][
            'fallbacks' if name == 'port' else 'fallback_rounds'] > 0
    assert outs['port'] == outs['jax']


def test_draft_cache_resync_after_fallback_burst(jax_spec, params):
    """Plain fallback steps write the target cache only; the resumed
    speculative round copies the target's blocks into the draft pool first,
    so the draft cache holds the target's rows bitwise at every earlier
    position and the accept rate stays exactly 1.0. The counts equal the
    JAX engine's."""
    pg = _prompt(6, 41)
    counts = {}
    for name, e in (('jax', JGenerateEngine(_spec('jax'),
                                            scope=jax_spec.scope)),
                    ('port', GenerateEngine(_spec(), params=params,
                                            device='cpu'))):
        ref = e.generate_once(pg, max_new_tokens=18)
        e.warmup()
        g = e.submit(pg, max_new_tokens=18)
        s = e.submit(_prompt(9, 42), max_new_tokens=5, temperature=0.8,
                     top_k=8, sample_seed=7)
        _drive(e, s)            # the sampled rider: every step falls back
        assert g.finish_reason is None
        if name == 'port':
            st = next(x for x in e._slots if x is not None and x.req is g)
            pos_before = st.pos
            e._step()           # the resumed round: resync, then draft
            for p in range(pos_before):
                tb, db = st.blocks[p // BS], st.dblocks[p // BS]
                assert torch.equal(e.model.k_cache[tb, :, :, p % BS],
                                   e.draft.k_cache[db, :, :, p % BS]), p
                assert torch.equal(e.model.v_cache[tb, :, :, p % BS],
                                   e.draft.v_cache[db, :, :, p % BS]), p
        _drive(e, g)
        assert list(g.result(5)) == ref
        e.stop()
        sp = e.stats()['spec']
        counts[name] = [sp[k] for k in ('rounds', 'proposed', 'accepted',
                                        'stale_draft_rounds')] + \
            [sp['fallbacks' if name == 'port' else 'fallback_rounds']]
        assert sp['accept_rate'] == 1.0 and sp['stale_draft_rounds'] >= 1
    assert counts['port'] == counts['jax']
    assert e.counters['spec_stale_draft_rounds_total'] >= 1


def test_chunked_prefill_with_sharing_under_speculation(jax_spec, params):
    """A 40-token prompt (past the widest bucket: chunked) twice: the
    second hits the prefix cache, both decode speculatively, and both equal
    a single-shot prefill's tokens and the JAX engine's."""
    p = _prompt(40, 21)
    ref = GenerateEngine(_cfg(prompt_buckets=[40]), params=params,
                         device='cpu').generate_once(p, max_new_tokens=8)
    jeng = JGenerateEngine(_spec('jax'), scope=jax_spec.scope)
    with jeng:
        jouts = [list(jeng.submit(p, max_new_tokens=8).result(60))
                 for _ in range(2)]
    eng = GenerateEngine(_spec(), params=params, device='cpu')
    with eng:
        outs = [list(eng.submit(p, max_new_tokens=8).result(60))
                for _ in range(2)]
    assert outs == jouts == [ref, ref]
    assert eng.counters['kv_prefix_hit_total{outcome=hit}'] >= 1
    assert eng.stats()['spec']['accept_rate'] == 1.0


def test_config_checks():
    with pytest.raises(ValueError, match='paged=True'):
        GenerateConfig(model=LMConfig(**LM), speculative=True, paged=False)
    with pytest.raises(ValueError, match='spec_k'):
        _spec(spec_k=0)
    with pytest.raises(ValueError, match='vocab_size'):
        _spec(draft_model=LMConfig(**dict(LM, vocab_size=128)))
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        _spec(metrics_port=0)
    c = _spec()
    assert (c.speculative, c.spec_k, c.draft_model) == (True, K, None)
    assert _cfg().speculative is False
    assert GenerateConfig().spec_k == 4
