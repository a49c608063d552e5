"""paddle_tpu_torch ops against the JAX package, on the CPU.

For each port module that holds a CUDA kernel, its plain PyTorch version
(what a CPU tensor runs) is compared with the JAX function run as the JAX
package's own tests run it: the Pallas kernels through the interpreter
(``'interpret'``). The decode-side ops (KV cache writes, cached attention,
sampling) are plain jnp op lowerings in the JAX package, driven here
through one-op programs.

Inputs come from a numpy seed and go through both packages. Tolerances:
f32 rtol 1e-4 / atol 1e-5 where the two sides sum in different orders;
atol 1e-4 for the FFN (erf and two long f32 dot products); bitwise for
the gather, the cache writes and the token choice (argmax and the sampled
index), which involve no reassociated arithmetic.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as fluid
from paddle_tpu import goodput, monitor
from paddle_tpu.framework import Program, program_guard
from paddle_tpu.ops import attention_ops as jattn
from paddle_tpu.ops import embedding_ops as jemb
from paddle_tpu.ops import ffn_ops as jffn
from paddle_tpu.ops import nn_ops as jnn
from paddle_tpu.ops.tensor_ops import position_encoding_table as jpe

from paddle_tpu_torch.ops import (attention_ops, embedding_ops, ffn_ops,
                                  kernel_tier, kv_cache_ops, nn_ops,
                                  tensor_ops)
from paddle_tpu_torch.reader.bucketing import bucketize

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope='module', autouse=True)
def _fresh_goodput_window():
    """Driving the JAX executor arms the process-wide goodput sentinels;
    restart the window after this module."""
    yield
    goodput.reset()
    # the monitor keeps at most 64 series a metric: leave it empty
    monitor.reset()


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# kernel modules vs the interpret-mode Pallas kernels


@pytest.mark.parametrize('with_bias', [False, True])
def test_embedding_gather_matches_pallas_interpret(with_bias):
    rs = np.random.RandomState(0)
    V, D = 40, 128
    w = rs.randn(V, D).astype('float32')
    # out-of-range ids clamp to the first/last row in both packages
    ids = np.array([3, 0, 39, 17, -2, 45, 17], 'int64')
    bias = rs.randn(D).astype('float32') if with_bias else None
    want = jemb.embedding_gather(jnp.asarray(w), jnp.asarray(ids),
                                 None if bias is None else jnp.asarray(bias),
                                 impl='interpret')
    got = embedding_ops.embedding_gather(
        _t(w), _t(ids), None if bias is None else _t(bias))
    np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.mark.parametrize('n', [8, 32])
def test_fused_ln_residual_matches_pallas_interpret(n):
    rs = np.random.RandomState(n)
    D = 128
    x, r = rs.randn(n, D).astype('float32'), rs.randn(n, D).astype('float32')
    sc = (1 + 0.1 * rs.randn(D)).astype('float32')
    b = (0.1 * rs.randn(D)).astype('float32')
    y_j, s_j = jnn.fused_ln_residual(x, r, sc, b, 1e-5, 'interpret')
    _, _, m_j, rs_j = jnn._ln_res_fwd_pallas(x, r, sc, b, 1e-5, True)
    y, s, m, rstd = nn_ops.fused_ln_residual(_t(x), _t(r), _t(sc), _t(b),
                                             1e-5)
    np.testing.assert_array_equal(s.numpy(), _np(s_j))   # one f32 add
    for got, want in ((y, y_j), (m, m_j), (rstd, rs_j)):
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL,
                                   atol=ATOL)


def test_fused_ln_residual_keeps_leading_shape():
    rs = np.random.RandomState(3)
    x, r = rs.randn(2, 5, 64).astype('float32'), \
        rs.randn(2, 5, 64).astype('float32')
    sc, b = np.ones(64, 'float32'), np.zeros(64, 'float32')
    y, s, m, rstd = nn_ops.fused_ln_residual(_t(x), _t(r), _t(sc), _t(b))
    assert y.shape == (2, 5, 64) and s.shape == (2, 5, 64)
    assert m.shape == (10,) and rstd.shape == (10,)


def test_layer_norm_matches_jax_lowering_formula():
    rs = np.random.RandomState(4)
    x = rs.randn(6, 96).astype('float32')
    sc = rs.randn(96).astype('float32')
    b = rs.randn(96).astype('float32')
    m = x.mean(-1, keepdims=True)
    v = x.var(-1, keepdims=True)
    want = (x - m) / np.sqrt(v + 1e-5) * sc + b
    got = nn_ops.layer_norm(_t(x), _t(sc), _t(b), 1e-5)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('with_mask', [False, True])
def test_fused_ffn_matches_pallas_interpret(with_mask):
    rs = np.random.RandomState(5)
    n, d, f = 16, 128, 256
    x = rs.randn(n, d).astype('float32')
    w1 = (0.05 * rs.randn(d, f)).astype('float32')
    b1 = (0.05 * rs.randn(f)).astype('float32')
    w2 = (0.05 * rs.randn(f, d)).astype('float32')
    b2 = (0.05 * rs.randn(d)).astype('float32')
    mask = ((rs.rand(n, d) > 0.3) / 0.7).astype('float32') \
        if with_mask else None
    y_j, pre1_j = jffn._ffn_fwd_pallas(x, w1, b1, w2, b2, mask, True)
    y_core = jffn.fused_ffn_core(x, w1, b1, w2, b2, mask, 'interpret')
    y, pre1 = ffn_ops.fused_ffn_core(
        _t(x), _t(w1), _t(b1), _t(w2), _t(b2),
        None if mask is None else _t(mask), want_pre1=True)
    # erf, and f32 dot products of length 128 and 256 summed in another
    # order: 1e-4 absolute
    np.testing.assert_allclose(y.numpy(), _np(y_j), rtol=RTOL, atol=1e-4)
    np.testing.assert_allclose(y.numpy(), _np(y_core), rtol=RTOL, atol=1e-4)
    np.testing.assert_allclose(pre1.numpy(), _np(pre1_j), rtol=RTOL,
                               atol=1e-4)
    _, none = ffn_ops.fused_ffn_core(_t(x), _t(w1), _t(b1), _t(w2), _t(b2))
    assert none is None


@pytest.mark.parametrize('causal', [True, False])
def test_flash_attention_matches_pallas_interpret(causal):
    rs = np.random.RandomState(6)
    B, H, L, dh = 1, 2, 32, 64
    q, k, v = (rs.randn(B, H, L, dh).astype('float32') for _ in range(3))
    want = jattn.flash_attention(q, k, v, causal=causal,
                                 use_pallas='interpret')
    o_j, lse_j = jattn._flash_fwd_pallas(
        q.reshape(B * H, L, dh), k.reshape(B * H, L, dh),
        v.reshape(B * H, L, dh), dh ** -0.5, causal, True, jattn._DEF_BQ,
        jattn._DEF_BK)
    o, lse = attention_ops.flash_attention(_t(q), _t(k), _t(v),
                                           causal=causal, return_lse=True)
    np.testing.assert_allclose(o.numpy(), _np(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(o.numpy().reshape(B * H, L, dh), _np(o_j),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lse.numpy().reshape(B * H, L), _np(lse_j),
                               rtol=RTOL, atol=ATOL)


def test_flash_attention_3d_form_and_unported_bias():
    """[BH, L, dh] input gives the 4-d result; a zero key-padding bias
    changes nothing, and a dropped key has exactly no weight (the output
    equals attention over the kept keys alone)."""
    rs = np.random.RandomState(7)
    B, H, L, dh = 2, 2, 16, 32
    q, k, v = (rs.randn(B, H, L, dh).astype('float32') for _ in range(3))
    o4 = attention_ops.flash_attention(_t(q), _t(k), _t(v))
    o3 = attention_ops.flash_attention(*(_t(a.reshape(B * H, L, dh))
                                         for a in (q, k, v)))
    np.testing.assert_array_equal(o3.numpy(), o4.numpy().reshape(-1, L, dh))
    o0 = attention_ops.flash_attention(_t(q), _t(k), _t(v),
                                       key_padding_bias=torch.zeros(B, L))
    np.testing.assert_array_equal(o0.numpy(), o4.numpy())
    bias = torch.zeros(B, L)
    bias[:, L - 5:] = -1e9
    ob = attention_ops.flash_attention(_t(q), _t(k), _t(v), causal=False,
                                       key_padding_bias=bias)
    s = torch.einsum('bhqd,bhkd->bhqk', _t(q), _t(k[:, :, :L - 5])) \
        * dh ** -0.5
    want = torch.einsum('bhqk,bhkd->bhqd', torch.softmax(s, -1),
                        _t(v[:, :, :L - 5]))
    np.testing.assert_allclose(ob.numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_position_encoding_table_is_bitwise_the_jax_table():
    for L, D in ((64, 128), (7, 33)):
        np.testing.assert_array_equal(
            tensor_ops.position_encoding_table(L, D), jpe(L, D))
    x = torch.zeros(1, 5, 16)
    np.testing.assert_array_equal(
        tensor_ops.add_position_encoding(x)[0].numpy(), jpe(5, 16))


# ---------------------------------------------------------------------------
# dispatch rule


def test_cpu_tensors_take_plain_version_and_count_nothing():
    before = kernel_tier.launch_counts()
    assert set(before) == set(kernel_tier.KERNELS)
    w = torch.randn(10, 8)
    embedding_ops.embedding_gather(w, torch.tensor([1, 2]))
    nn_ops.fused_ln_residual(torch.randn(2, 8), torch.randn(2, 8),
                             torch.ones(8), torch.zeros(8))
    attention_ops.flash_attention(*(torch.randn(1, 4, 16)
                                    for _ in range(3)))
    ffn_ops.fused_ffn_core(torch.randn(2, 8), torch.randn(8, 16),
                           torch.zeros(16), torch.randn(16, 8),
                           torch.zeros(8))
    assert kernel_tier.launch_counts() == before


def test_mixed_devices_raise():
    with pytest.raises(RuntimeError, match='all lie on one CUDA device'):
        kernel_tier.on_cuda(torch.zeros(2), torch.zeros(2, device='meta'))
    assert kernel_tier.on_cuda(torch.zeros(1), None) is False


def test_bucketize_copy():
    assert bucketize(5, [16, 32]) == 16
    assert bucketize(32, [16, 32]) == 32
    with pytest.raises(ValueError, match='exceeds the largest bucket'):
        bucketize(33, [16, 32])


# ---------------------------------------------------------------------------
# KV-cache ops and sampling vs the JAX op lowerings (one-op programs)


def _run_op(op_type, inputs, out_slot, attrs=None):
    prog, startup = Program(), Program()
    feed = {}
    with program_guard(prog, startup):
        block = prog.global_block()
        in_map = {}
        for slot, arr in inputs.items():
            arr = np.asarray(arr)
            in_map[slot] = [block.create_var(name='in_' + slot,
                                             shape=arr.shape,
                                             dtype=arr.dtype)]
            feed['in_' + slot] = arr
        out = block.create_var(name='out', dtype='float32')
        block.append_op(type=op_type, inputs=in_map,
                        outputs={out_slot: [out]}, attrs=attrs or {})
    return np.asarray(fluid.Executor().run(prog, feed=feed,
                                           fetch_list=['out'])[0])


S, LN, H, M, DH = 4, 2, 2, 16, 8


def _cache(rs):
    return rs.randn(S, LN, H, M, DH).astype('float32')


def test_kv_cache_prefill_matches_jax():
    rs = np.random.RandomState(8)
    cache, new = _cache(rs), rs.randn(1, H, 5, DH).astype('float32')
    want = _run_op('kv_cache_prefill',
                   {'Cache': cache, 'New': new,
                    'Slot': np.array([[2]], 'int64')}, 'Out', {'layer': 1})
    got = kv_cache_ops.kv_cache_prefill(_t(cache.copy()), _t(new), 2, 1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_kv_cache_update_matches_jax():
    rs = np.random.RandomState(9)
    cache, new = _cache(rs), rs.randn(S, H, DH).astype('float32')
    pos = np.array([[3], [0], [15], [7]], 'int64')
    want = _run_op('kv_cache_update', {'Cache': cache, 'New': new,
                                       'Positions': pos}, 'Out',
                   {'layer': 0})
    c = _t(cache.copy())
    out = kv_cache_ops.kv_cache_update(c, _t(new), _t(pos.reshape(-1)), 0)
    assert out is c                     # in place
    np.testing.assert_array_equal(c.numpy(), want)


def test_kv_decode_attention_matches_jax_and_zeroes_stale_rows():
    rs = np.random.RandomState(10)
    kc, vc = _cache(rs), _cache(rs)
    q = rs.randn(S, H, DH).astype('float32')
    pos = np.array([[3], [0], [15], [7]], 'int64')
    want = _run_op('kv_decode_attention',
                   {'Q': q, 'KCache': kc, 'VCache': vc, 'Positions': pos},
                   'Out', {'layer': 1, 'scale': DH ** -0.5})
    args = (_t(q), _t(kc), _t(vc), _t(pos.reshape(-1)), 1, DH ** -0.5)
    got = kv_cache_ops.kv_decode_attention(*args)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # stale rows past each slot's position: huge garbage contributes an
    # exact 0 (a select, not exp underflow; as in the JAX op, the rows are
    # finite — the cache starts zeroed and only ever holds written rows)
    kc2, vc2 = kc.copy(), vc.copy()
    for s, p in enumerate(pos[:, 0]):
        kc2[s, 1, :, p + 1:] = 3e38
        vc2[s, 1, :, p + 1:] = -3e38
    got2 = kv_cache_ops.kv_decode_attention(
        _t(q), _t(kc2), _t(vc2), _t(pos.reshape(-1)), 1, DH ** -0.5)
    np.testing.assert_array_equal(got2.numpy(), got.numpy())


def test_sample_next_token_matches_jax_bitwise():
    rs = np.random.RandomState(11)
    n, V = 8, 50
    logits = rs.randn(n, V).astype('float32')
    logits[0, [4, 9]] = 5.0             # tied max: first index wins
    logits[1, :] = 0.0                  # all tied: stable order
    temp = np.array([0, 0.7, 1.0, 1.3, 0.5, 0.9, 2.0, 0],
                    'float32')[:, None]
    topk = np.array([0, 5, 0, 10, 3, 0, 1, 7], 'int64')[:, None]
    topp = np.array([0, 0, 0.9, 0.5, 0, 1.0, 0.3, 0.8],
                    'float32')[:, None]
    u = rs.rand(n, 1).astype('float32')
    want = _run_op('sample_next_token',
                   {'Logits': logits, 'Temp': temp, 'TopK': topk,
                    'TopP': topp, 'U': u}, 'Out')
    got = kv_cache_ops.sample_next_token(
        _t(logits), _t(temp[:, 0]), _t(topk[:, 0]), _t(topp[:, 0]),
        _t(u[:, 0]))
    np.testing.assert_array_equal(got.numpy(), want.astype('int64'))
    assert got[0] == 4
    # all-greedy rows: the host flag skips the sort, same answer
    zero = torch.zeros(n)
    greedy = kv_cache_ops.sample_next_token(
        _t(logits), zero, zero.long(), zero, zero, any_sampled=False)
    np.testing.assert_array_equal(greedy.numpy(), logits.argmax(1))
