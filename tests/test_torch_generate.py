"""The decode slice as a whole: paddle_tpu_torch's GenerateEngine against
the JAX package's, on the CPU, on the same weights.

The JAX engine initialises its parameters from its seed; the port's engine
(``device='cpu'``) takes them by name through
``paddle_tpu_torch.io.params_from_numpy`` — straight from the JAX scope,
and through ``paddle_tpu.io.save_params`` / ``paddle_tpu_torch.io
.read_params``. Greedy tokens and seeded sampled tokens must be identical;
first-token and decode-step logits agree within rtol 1e-4 / atol 1e-4
(f32 through two layers, summed in other orders; the flash op on the JAX
side runs its jnp reference on the CPU). The port's own continuous
batcher must equal its own sequential reference exactly.
"""
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import goodput, monitor
from paddle_tpu.models.transformer import LMConfig as JLMConfig
from paddle_tpu.serving import GenerateConfig as JGenerateConfig
from paddle_tpu.serving import GenerateEngine as JGenerateEngine

from paddle_tpu_torch.io import params_from_numpy, read_params
from paddle_tpu_torch.models.transformer import LMConfig, param_shapes
from paddle_tpu_torch.serving import (DeadlineExceededError,
                                      EngineStoppedError, GenerateConfig,
                                      GenerateEngine, LoadShedError)

V = 256
BUCKETS = [16, 32]
MAX_LEN = 64
SLOTS = 8
LM = dict(vocab_size=V, seq_len=32, d_model=128, n_head=2, n_layer=2,
          d_ff=256, dropout=0.0, attn_dropout=0.0)


def _port_cfg(**kw):
    kw.setdefault('model', LMConfig(**LM))
    kw.setdefault('slots', SLOTS)
    kw.setdefault('max_len', MAX_LEN)
    kw.setdefault('prompt_buckets', list(BUCKETS))
    return GenerateConfig(**kw)


def _prompt(n, seed=0):
    return np.random.RandomState(seed).randint(2, V, size=n).astype('int64')


@pytest.fixture(scope='module', autouse=True)
def _fresh_goodput_window():
    """The JAX engine's steady decode arms the process-wide goodput
    sentinels (recompile-storm detection starts once a signature's
    baseline froze); restart the window after this module so later test
    files in the same worker see a cold one."""
    yield
    goodput.reset()
    # the monitor keeps at most 64 series a metric: leave it empty
    monitor.reset()


@pytest.fixture(scope='module')
def jax_engine():
    eng = JGenerateEngine(JGenerateConfig(
        model=JLMConfig(**LM), slots=SLOTS, max_len=MAX_LEN,
        prompt_buckets=list(BUCKETS), seed=3))
    eng.warmup()
    return eng


@pytest.fixture(scope='module')
def jax_params(jax_engine):
    s = jax_engine.scope
    return {n: np.asarray(s.get(n)) for n in s.names()}


@pytest.fixture(scope='module')
def port_engine(jax_params):
    return GenerateEngine(_port_cfg(), params=jax_params, device='cpu')


WORK = [(_prompt(4, 1), 9), (_prompt(7, 2), 14), (_prompt(12, 3), 6),
        (_prompt(16, 4), 11), (_prompt(5, 5), 8), (_prompt(9, 6), 13)]


def test_params_from_numpy_maps_every_jax_name(jax_params):
    assert 'gen_kv_k' in jax_params          # cache state rides the scope
    p = params_from_numpy(jax_params, 'cpu', config=LMConfig(**LM))
    assert list(p) == list(param_shapes(LMConfig(**LM)))
    np.testing.assert_array_equal(p['layer_1.ffn2.w'].numpy(),
                                  jax_params['layer_1.ffn2.w'])
    inferred = params_from_numpy(jax_params, 'cpu')
    assert set(inferred) == set(p)


def test_params_from_numpy_rejects_bad_names_and_shapes(jax_params):
    bad = dict(jax_params)
    del bad['final_ln.b']
    with pytest.raises(ValueError, match="missing \\['final_ln.b'\\]"):
        params_from_numpy(bad, config=LMConfig(**LM))
    bad = dict(jax_params, stray=np.zeros(3))
    with pytest.raises(ValueError, match="unexpected \\['stray'\\]"):
        params_from_numpy(bad, config=LMConfig(**LM))
    bad = dict(jax_params)
    bad['lm_head.w'] = bad['lm_head.w'][:, :10]
    with pytest.raises(ValueError, match="'lm_head.w' has shape"):
        params_from_numpy(bad, config=LMConfig(**LM))


@pytest.mark.parametrize('combined', [False, True])
def test_save_params_then_load_params_serves_same_tokens(
        jax_engine, port_engine, tmp_path, combined):
    filename = 'params' if combined else None
    with fluid.scope_guard(jax_engine.scope):
        fluid.io.save_params(jax_engine.executor, str(tmp_path),
                             main_program=jax_engine._step_prog,
                             filename=filename)
    loaded = read_params(str(tmp_path), filename=filename)
    eng = GenerateEngine(_port_cfg(), params=loaded, device='cpu')
    p = _prompt(10, 9)
    assert eng.generate_once(p, max_new_tokens=6) == \
        port_engine.generate_once(p, max_new_tokens=6)


def test_greedy_tokens_identical_to_jax(jax_engine, port_engine):
    for p, n in WORK:
        assert port_engine.generate_once(p, max_new_tokens=n) == \
            jax_engine.generate_once(p, max_new_tokens=n)


@pytest.mark.parametrize('sampling', [
    dict(temperature=0.8, sample_seed=11),
    dict(temperature=1.2, top_k=20, sample_seed=12),
    dict(temperature=0.9, top_p=0.9, sample_seed=13),
])
def test_seeded_sampled_tokens_identical_to_jax(jax_engine, port_engine,
                                                sampling):
    for p, n in WORK[:3]:
        got = port_engine.generate_once(p, max_new_tokens=n, **sampling)
        want = jax_engine.generate_once(p, max_new_tokens=n, **sampling)
        assert got == want


def test_prefill_and_step_logits_match_jax(jax_engine, port_engine):
    """First-token logits of a prefill, then one decode step's logits for
    the same slot, against the JAX programs run on the same feeds."""
    c = jax_engine.config
    p = _prompt(11, 21)
    b = 16
    padded = np.zeros((1, b), 'int64')
    padded[0, :p.size] = p
    prog, v = jax_engine._prefill[b]
    feed = {'gen_prompt': padded, 'gen_slot': np.array([[2]], 'int64'),
            'gen_len': np.array([[p.size]], 'int64')}
    feed.update(jax_engine._sample_feed(1))
    want, = jax_engine.executor.run(prog, feed=feed,
                                    fetch_list=[v['logits']],
                                    scope=jax_engine.scope)
    first, got = port_engine.model.prefill(torch.from_numpy(padded), 2,
                                           p.size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    toks = np.zeros((c.slots, 1), 'int64')
    pos = np.zeros((c.slots, 1), 'int64')
    toks[2], pos[2] = int(first[0]), p.size
    feed = {'gen_tokens': toks, 'gen_pos': pos}
    feed.update(jax_engine._sample_feed(c.slots))
    want, = jax_engine.executor.run(
        jax_engine._step_prog, feed=feed,
        fetch_list=[jax_engine._step_vars['logits']],
        scope=jax_engine.scope)
    _, got = port_engine.model.decode_step(torch.from_numpy(toks[:, 0]),
                                           torch.from_numpy(pos[:, 0]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want)[2],
                               rtol=1e-4, atol=1e-4)


def test_concurrent_submit_equals_own_generate_once(port_engine):
    """Continuous batching (the mixed workload of tests/test_generate.py,
    plus seeded sampled riders) equals the sequential reference exactly."""
    work = [(p, n, {}) for p, n in WORK] + \
        [(p, n, dict(temperature=0.7, top_k=30, sample_seed=100 + i))
         for i, (p, n) in enumerate(WORK[:3])]
    refs = [port_engine.generate_once(p, max_new_tokens=n, **kw)
            for p, n, kw in work]
    eng = GenerateEngine(_port_cfg(), params={
        k: v for k, v in port_engine.model.p.items()}, device='cpu')
    with eng:
        reqs = [eng.submit(p, max_new_tokens=n, **kw) for p, n, kw in work]
        outs = [r.result(60) for r in reqs]
    for out, ref, (p, n, _) in zip(outs, refs, work):
        assert out == ref
        assert out.finish_reason == 'length'
        assert out.timing['tokens'] == n
        assert out.timing['total_s'] >= out.timing['prefill_s'] > 0
    st = eng.stats()
    assert st['active'] == 0 and st['peak_active'] > 1
    assert st['decode_tokens'] == sum(n for _, n, _ in work)


def test_finish_reasons_cache_full_and_eos(port_engine):
    p = _prompt(10, 7)
    ref = port_engine.generate_once(p, max_new_tokens=200)
    assert len(ref) == MAX_LEN - p.size + 1
    eos = ref[3]
    eng = GenerateEngine(_port_cfg(eos_id=eos), params=dict(
        port_engine.model.p), device='cpu')
    with eng:
        full = eng.submit(p, max_new_tokens=200)
        stop = eng.submit(p, max_new_tokens=200)
        streamed = list(stop.stream(timeout=60))
    out = full.result(60)
    assert out.finish_reason == 'eos' and out == ref[:ref.index(eos) + 1]
    assert streamed == list(out)
    eng2 = GenerateEngine(_port_cfg(), params=dict(port_engine.model.p),
                          device='cpu')
    with eng2:
        r = eng2.submit(p, max_new_tokens=200).result(60)
    assert r.finish_reason == 'cache_full' and r == ref


def test_admission_control_shed_deadline_stop_and_rejects(port_engine):
    eng = GenerateEngine(_port_cfg(queue_cap=2), params=dict(
        port_engine.model.p), device='cpu')
    warm = eng.warmup()
    assert warm['buckets'] == len(BUCKETS) and warm['seconds'] >= 0
    with pytest.raises(ValueError, match='outside \\[1, 32\\]'):
        eng.submit(_prompt(33))
    with pytest.raises(ValueError, match='top_p'):
        eng.submit(_prompt(3), top_p=1.5)
    late = eng.submit(_prompt(3), deadline_s=0.0)
    queued = eng.submit(_prompt(4), max_new_tokens=5)
    with pytest.raises(LoadShedError) as e:
        eng.submit(_prompt(5))
    assert e.value.queue_cap == 2
    threading.Event().wait(0.01)
    with eng:
        with pytest.raises(DeadlineExceededError):
            late.result(30)
        assert len(queued.result(30)) == 5
    never = GenerateEngine(_port_cfg(), params=dict(port_engine.model.p),
                           device='cpu')
    pending = never.submit(_prompt(4))
    never.stop()
    with pytest.raises(EngineStoppedError):
        pending.result(5)
    with pytest.raises(EngineStoppedError):
        never.start()


def test_not_ported_modes_raise():
    # ported: the metrics endpoint (tests/test_torch_monitor.py serves
    # it), speculative decoding on the paged cache
    # (tests/test_torch_speculative.py), which the contiguous cache refuses
    # as the JAX package's does; the paged cache (tests/test_torch_paged.py)
    # and the unfused prefill of use_flash_attention=False
    with pytest.raises(ValueError, match='paged=True'):
        GenerateConfig(speculative=True)
    assert GenerateConfig(speculative=True, paged=True).speculative
    assert GenerateConfig(paged=True).paged
    assert GenerateConfig(metrics_port=0).metrics_port == 0
    eng = GenerateEngine(_port_cfg(model=LMConfig(
        use_flash_attention=False, **LM)), device='cpu')
    assert len(eng.generate_once(_prompt(5), max_new_tokens=3)) == 3


def test_deadline_evicts_mid_generation_and_neighbours_finish(port_engine):
    """A resident whose deadline passes is evicted at a token boundary
    with DeadlineExceededError; a co-resident request still returns
    exactly its sequential tokens. Inline calls on a started engine
    raise."""
    p_slow, p_ok = _prompt(6, 30), _prompt(9, 31)
    ref = port_engine.generate_once(p_ok, max_new_tokens=20)
    eng = GenerateEngine(_port_cfg(), params=dict(port_engine.model.p),
                         device='cpu')
    with eng:
        doomed = eng.submit(p_slow, max_new_tokens=55, deadline_s=0.02)
        ok = eng.submit(p_ok, max_new_tokens=20)
        with pytest.raises(DeadlineExceededError):
            doomed.result(30)
        assert ok.result(30) == ref
        with pytest.raises(RuntimeError, match='started engine'):
            eng.generate_once(p_ok)
        with pytest.raises(RuntimeError, match='started engine'):
            eng.warmup()
    assert eng.stats()['active'] == 0
