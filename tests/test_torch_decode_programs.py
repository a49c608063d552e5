"""The decode engine's Fluid programs in paddle_tpu_torch against the JAX
package, on the CPU: `build_lm_prefill` and `build_lm_decode_step` on the
contiguous cache, `build_lm_prefill_paged`, the paged decode step,
`build_lm_drafter` and `build_lm_verify` on the paged one, at V 64, d 32, 2
heads, 2 layers, 3 slots, max_len 32, blocks of 8, spec_k 3
(tests/torch_decode_cases.py).

Both packages start from one JAX startup scope (the port's through
``io.scope_from_numpy``) with zeroed caches. Each slot's prompt is
prefilled (lengths 5, 8, 3), then 6 decode steps run, slot 1 sampling
(temperature 0.8, top-k 10, top-p 0.9, a fixed ``gen_u`` a step) and the
others greedy; in the paged cache a drafter round and its verify step
follow. The port runs the sequence through ``Executor.run`` and through
``Executor.bind`` (one bound program a program, each called with its
feeds) and is held to the JAX executor's run: every token equal, the
logits within 1e-5 relative (1e-6 absolute, for logits near 0), each
cache at the end within 1e-5 of its largest magnitude. The tokens also
equal `TransformerLM`'s ``prefill``, ``prefill_paged``, ``decode_step``,
``draft_steps`` and ``verify_step`` on the same weights. A bound program
writes the scope's caches in place (the scope keeps the same tensors)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as jfluid
from paddle_tpu import goodput, monitor
from paddle_tpu.models import transformer as jtrans

import paddle_tpu_torch as fluid
from paddle_tpu_torch.io import params_from_numpy, scope_from_numpy
from paddle_tpu_torch.models import transformer as ttrans

import torch_decode_cases as C

CPU = fluid.CPUPlace()
STEPS = 6
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope='module', autouse=True)
def _fresh_goodput_window():
    """Driving the JAX executor arms the process-wide goodput sentinels and
    fills monitor series; leave both empty after this module."""
    yield
    goodput.reset()
    monitor.reset()


def _fetch_names(which, v):
    if which in ('prefill', 'prefill_paged'):
        return [v['first_token'], v['logits']]
    if which.startswith('decode_step'):
        return [v['next_tokens'], v['logits']]
    if which == 'drafter':
        return [v['draft_tokens']]
    return [v['verify_tokens'], v['logits']]


class _Runs(object):
    """One package's programs on one scope: ``run(which, feed)`` returns
    the fetches as numpy arrays, through ``Executor.run`` or, with
    ``bind``, through one bound program a program."""

    def __init__(self, pkg, tmod, exe, scope, bind=False):
        self.progs = {w: C.build(pkg, tmod, w) for w in C.PROGRAMS}
        self.exe, self.scope, self.bind = exe, scope, bind
        self.bound = {}

    def run(self, which, feed):
        main, _, v = self.progs[which]
        fetch = _fetch_names(which, v)
        if not self.bind:
            out = self.exe.run(main, feed=feed, fetch_list=fetch,
                               scope=self.scope)
        elif which not in self.bound:
            self.bound[which] = self.exe.bind(main, feed, fetch_list=fetch,
                                              scope=self.scope)
            out = self.bound[which].first_out
        else:
            out = self.bound[which](feed)
        return [np.asarray(o) for o in out]


def _session(runs, paged):
    """The prefills, STEPS decode steps and (paged) a drafter round and
    its verify step: [(what, fetches)]."""
    pre = 'prefill_paged' if paged else 'prefill'
    step = 'decode_step_paged' if paged else 'decode_step'
    out, tokens = [], []
    for s, prompt in enumerate(C.prompts()):
        f = runs.run(pre, C.prefill_feed(s, prompt, paged))
        out.append(('%s slot %d' % (pre, s), f))
        tokens.append(int(f[0].reshape(-1)[0]))
    pos = np.asarray(C.LENGTHS, 'int64')
    for k in range(STEPS):
        f = runs.run(step, C.decode_feed(tokens, pos, k, paged))
        out.append(('%s %d' % (step, k), f))
        tokens, pos = f[0].reshape(-1), pos + 1
    if paged:
        drafts = runs.run('drafter', C.drafter_feed(tokens, pos))
        out.append(('drafter', drafts))
        out.append(('verify', runs.run(
            'verify', C.verify_feed(tokens, drafts[0], pos))))
    return out


def _model_session(params, paged):
    """The same session through `TransformerLM`'s methods: the tokens of
    each entry of `_session`."""
    cfg = C.config(ttrans)
    m = ttrans.TransformerLM(cfg, params, C.MAX_LEN)
    if paged:
        m.allocate_paged_cache(C.NUM_BLOCKS, C.BLOCK)
    else:
        m.allocate_cache(C.SLOTS)
    t = torch.from_numpy

    def sample(feed):
        return tuple(t(feed[n].reshape(-1)) for n in C.SAMPLE_FEEDS) + (True,)

    out, tokens = [], []
    for s, prompt in enumerate(C.prompts()):
        f = C.prefill_feed(s, prompt, paged)
        if paged:
            tok, _ = m.prefill_paged(t(prompt), t(f['gen_pos']),
                                     t(f['gen_btab'][0]), C.LENGTHS[s],
                                     sample(f))
        else:
            tok, _ = m.prefill(t(prompt), s, C.LENGTHS[s], sample(f))
        out.append(tok.numpy())
        tokens.append(int(tok[0]))
    pos = np.asarray(C.LENGTHS, 'int64')
    tables = t(C.tables()) if paged else None
    for k in range(STEPS):
        f = C.decode_feed(tokens, pos, k, paged)
        tok, _ = m.decode_step(t(f['gen_tokens'].reshape(-1)),
                               t(f['gen_pos'].reshape(-1)), sample(f),
                               tables=tables)
        out.append(tok.numpy())
        tokens, pos = tok.numpy(), pos + 1
    if paged:
        f = C.drafter_feed(tokens, pos)
        drafts = m.draft_steps(t(f['gen_tokens'].reshape(-1)),
                               t(f['gen_pos'].reshape(-1)), tables,
                               t(f['gen_vmask']), C.SPEC_K)
        out.append(drafts.numpy())
        f = C.verify_feed(tokens, drafts.numpy(), pos)
        out.append(m.verify_step(t(f['gen_tokens']), t(f['gen_pos']),
                                 tables, t(f['gen_vmask']))[0].numpy())
    return out


@pytest.fixture(scope='module')
def start_state():
    """The parameters of one JAX startup run (every program's parameters:
    one set of names)."""
    _, startup, _ = C.build(jfluid, jtrans, 'decode_step')
    scope = jfluid.Scope()
    jfluid.Executor().run(startup, scope=scope)
    return {n: np.array(scope.get(n)) for n in scope.names()
            if hasattr(scope.get(n), 'shape')}


def _hold_tokens(got, want, what):
    np.testing.assert_array_equal(np.asarray(got).reshape(-1),
                                  np.asarray(want).reshape(-1), err_msg=what)


def _hold_cache(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    top = float(np.abs(want).max())
    assert top > 0, what
    assert float(np.abs(got - want).max()) <= 1e-5 * top, what


@pytest.mark.parametrize('paged', [False, True])
def test_decode_programs_match_the_jax_executor(start_state, paged):
    shape = C.cache_shape(paged)
    jscope = jfluid.Scope()
    for n, a in start_state.items():
        jscope.set(n, a)
    for n in (jtrans.KV_CACHE_K, jtrans.KV_CACHE_V):
        jscope.set(n, jnp.zeros(shape, 'float32'))
    want = _session(_Runs(jfluid, jtrans, jfluid.Executor(), jscope), paged)

    model = _model_session(params_from_numpy(
        start_state, device='cpu', config=C.config(ttrans)), paged)
    for (what, w), m in zip(want, model):
        _hold_tokens(m, w[0], 'TransformerLM ' + what)

    for bind in (False, True):
        scope = scope_from_numpy(start_state, device='cpu')
        caches = [torch.zeros(shape) for _ in range(2)]
        scope.set(ttrans.KV_CACHE_K, caches[0])
        scope.set(ttrans.KV_CACHE_V, caches[1])
        got = _session(_Runs(fluid, ttrans, fluid.Executor(CPU), scope,
                             bind=bind), paged)
        how = 'bind' if bind else 'run'
        assert [w for w, _ in got] == [w for w, _ in want]
        for (what, g), (_, w) in zip(got, want):
            _hold_tokens(g[0], w[0], '%s %s tokens' % (how, what))
            if len(g) > 1:
                np.testing.assert_allclose(g[1], w[1], rtol=RTOL, atol=ATOL,
                                           err_msg='%s %s logits'
                                           % (how, what))
        # the writes landed in the scope's own tensors: no cache copied
        assert scope.get(ttrans.KV_CACHE_K) is caches[0]
        assert scope.get(ttrans.KV_CACHE_V) is caches[1]
        for n in (ttrans.KV_CACHE_K, ttrans.KV_CACHE_V):
            _hold_cache(scope.get(n).numpy(), np.asarray(jscope.get(n)),
                        '%s cache %s' % (how, n))


def test_decode_program_ops_are_registered():
    """The ten op types of the decode programs that the port lacked, and
    every op type the six programs emit, have lowerings."""
    from paddle_tpu_torch.core.registry import all_ops
    ops = set(all_ops())
    new = {'kv_cache_prefill', 'kv_cache_update', 'kv_decode_attention',
           'kv_cache_prefill_paged', 'kv_cache_update_paged',
           'kv_decode_attention_paged', 'kv_prefix_attention',
           'kv_cache_update_span_paged', 'kv_verify_attention_paged',
           'sample_next_token'}
    assert new <= ops
    for which in C.PROGRAMS:
        main, _, _ = C.build(fluid, ttrans, which)
        assert set(op.type for op in main.global_block().ops) <= ops, which
