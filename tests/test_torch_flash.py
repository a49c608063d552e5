"""paddle_tpu_torch's flash attention against the JAX package, on the CPU.

The port's forward (`flash_attention` with its LSE) and the plain version of
its two backward kernels (`_flash_bwd_ref`) are held against the Pallas
kernels `_flash_fwd_pallas` and `_flash_bwd_pallas` run through the
interpreter, the same numpy-seeded ``q, k, v, o, lse, do`` fed to both, for
{causal, full} x {no bias, a key-padding bias with padded tails}, and
causal with the bias at head width 256 (B 2, H 1, L 64, 32-row tiles:
the card's kernels split such a head's output columns over blocks). Then
the port's ``autograd.Function`` against ``jax.grad`` of
``flash_attention(..., use_pallas='interpret')``.

Tolerances are those of tests/test_attention.py for the same kernels
(B 2, H 2, L 256, dh 16, f32): rtol 2e-4 / atol 2e-5 on O and LSE (an
online softmax over 128-key tiles against one two-pass softmax), rtol 3e-3 /
atol 3e-4 on the gradients (three chained products of length 16 to 256,
summed in another order). A batch element whose keys are all padded gives
exact zeros in O, dQ, dK and dV.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from paddle_tpu.ops import attention_ops as jattn

from paddle_tpu_torch.ops import attention_ops, kernel_tier

B, H, L, DH = 2, 2, 256, 16
SCALE = DH ** -0.5
FWD_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=3e-3, atol=3e-4)
CASES = [(c, b) for c in (False, True) for b in (False, True)]
IDS = ['%s-%s' % ('causal' if c else 'full', 'bias' if b else 'nobias')
       for c, b in CASES]
# the Pallas comparisons at the file's shape, and one at head width 256
SHAPES = {'': (B, H, L, DH), 'dh256-': (2, 1, 64, 256)}
PALLAS_CASES = [(c, b, '') for c, b in CASES] + [(True, True, 'dh256-')]
PALLAS_IDS = IDS + ['dh256-causal-bias']


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _data(seed, biased, shape=(B, H, L, DH)):
    rs = np.random.RandomState(seed)
    q, k, v, do = (rs.randn(*shape).astype('float32') for _ in range(4))
    bias = None
    if biased:
        bias = np.zeros((shape[0], shape[2]), 'float32')
        bias[0, -40:] = -1e9
        bias[1, -7:] = -1e9
    return q, k, v, do, bias


def _flat(a):
    return a.reshape((-1,) + a.shape[2:])


def _tile(q):
    """The Pallas kernels' tile rows: two tiles of the [B, H, L, dh]
    operand's L, at most 128, so that the online softmax and the gradient
    sums take more than one."""
    return min(128, q.shape[2] // 2)


def _pallas_fwd(q, k, v, causal, bias):
    """(O, LSE) of the interpreted Pallas forward over [BH, L, dh] at the
    true width's scale, with `_tile` rows a tile."""
    return jattn._flash_fwd_pallas(
        jnp.asarray(_flat(q)), jnp.asarray(_flat(k)), jnp.asarray(_flat(v)),
        q.shape[-1] ** -0.5, causal, True, _tile(q), _tile(q),
        bias=None if bias is None else jnp.asarray(bias), n_heads=q.shape[1])


@pytest.mark.parametrize('causal,biased,shape', PALLAS_CASES, ids=PALLAS_IDS)
def test_forward_and_lse_match_pallas_interpret(causal, biased, shape):
    q, k, v, _, bias = _data(0, biased, SHAPES[shape])
    o_j, lse_j = _pallas_fwd(q, k, v, causal, bias)
    o, lse = attention_ops.flash_attention(
        _t(q), _t(k), _t(v), causal=causal, return_lse=True,
        key_padding_bias=None if bias is None else _t(bias))
    assert o.shape == q.shape and lse.shape == q.shape[:3]
    np.testing.assert_allclose(_flat(o.numpy()), np.asarray(o_j), **FWD_TOL)
    np.testing.assert_allclose(_flat(lse.numpy()), np.asarray(lse_j),
                               **FWD_TOL)


@pytest.mark.parametrize('causal,biased,shape', PALLAS_CASES, ids=PALLAS_IDS)
def test_backward_plain_version_matches_pallas_interpret(causal, biased,
                                                         shape):
    q, k, v, do, bias = _data(1, biased, SHAPES[shape])
    scale, heads = q.shape[-1] ** -0.5, q.shape[1]
    o_j, lse_j = _pallas_fwd(q, k, v, causal, bias)
    want = jattn._flash_bwd_pallas(
        jnp.asarray(_flat(q)), jnp.asarray(_flat(k)), jnp.asarray(_flat(v)),
        o_j, lse_j, jnp.asarray(_flat(do)), scale, causal, True, _tile(q),
        _tile(q), bias=None if bias is None else jnp.asarray(bias),
        n_heads=heads)
    got = attention_ops._flash_bwd_ref(
        _t(_flat(q)), _t(_flat(k)), _t(_flat(v)), _t(o_j), _t(lse_j),
        _t(_flat(do)), scale, causal,
        None if bias is None else _t(bias), heads)
    for name, g, w in zip(('dq', 'dk', 'dv'), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **GRAD_TOL)


@pytest.mark.parametrize('causal,biased', CASES, ids=IDS)
def test_autograd_function_matches_jax_grad(causal, biased):
    q, k, v, _, bias = _data(2, biased)
    jb = None if bias is None else jnp.asarray(bias)
    want = jax.grad(
        lambda a, b, c: jnp.sum(jattn.flash_attention(
            a, b, c, causal=causal, use_pallas='interpret',
            key_padding_bias=jb) ** 2), argnums=(0, 1, 2))(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_t(a, grad=True) for a in (q, k, v))
    before = kernel_tier.launch_counts()
    out = attention_ops.flash_attention(
        tq, tk, tv, causal=causal,
        key_padding_bias=None if bias is None else _t(bias))
    assert out.grad_fn is not None
    (out ** 2).sum().backward()
    # the CPU took the plain versions: nothing was counted as a launch
    assert kernel_tier.launch_counts() == before
    for name, t, w in zip('qkv', (tq, tk, tv), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   err_msg='d' + name, **GRAD_TOL)


@pytest.mark.parametrize('causal', [False, True], ids=['full', 'causal'])
def test_all_padded_element_gives_exact_zeros(causal):
    """Every key of batch element 0 is padded: l = 0, so O is 0, LSE is
    max + log(1e-30), and exp(s - lse) ~ e^69 in the backward unless the
    bias select zeroes P. The JAX kernels give exact zeros there too."""
    shape = (2, 2, 128, 16)
    q, k, v, do, _ = _data(5, False, shape)
    bias = np.zeros((2, 128), 'float32')
    bias[0, :] = -1e9
    bias[1, -9:] = -1e9
    tq, tk, tv = (_t(a, grad=True) for a in (q, k, v))
    o, lse = attention_ops.flash_attention(tq, tk, tv, causal=causal,
                                           return_lse=True,
                                           key_padding_bias=_t(bias))
    o.backward(_t(do))
    assert not o[0].any() and bool((lse[0] < -1e8).all())
    for t in (tq, tk, tv):
        g = t.grad
        assert torch.isfinite(g).all()
        assert not g[0].any()
        assert g[1].abs().max() > 0 and g.abs().max() < 1e3
    gq, gk, gv = jax.grad(
        lambda a, b, c: jnp.sum(jattn.flash_attention(
            a, b, c, causal=causal, use_pallas='interpret',
            key_padding_bias=jnp.asarray(bias)) * jnp.asarray(do)),
        argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for t, w in zip((tq, tk, tv), (gq, gk, gv)):
        assert not np.asarray(w)[0].any()
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **GRAD_TOL)
    # dropped keys of the other element take no dK, dV either
    assert not tk.grad[1, :, -9:].any() and not tv.grad[1, :, -9:].any()


def test_bias_takes_no_gradient_and_lse_is_not_differentiable():
    q, k, v, do, bias = _data(6, True, (2, 2, 32, 16))
    tb = _t(bias, grad=True)
    tq = _t(q, grad=True)
    o, lse = attention_ops.flash_attention(tq, _t(k), _t(v), causal=False,
                                           return_lse=True,
                                           key_padding_bias=tb)
    assert not lse.requires_grad
    o.backward(_t(do))
    assert tb.grad is None and tq.grad is not None


def test_rows_times_heads_layout_and_bias_shape_check():
    q, k, v, _, bias = _data(7, True, (2, 2, 32, 16))
    want = attention_ops.flash_attention(_t(q), _t(k), _t(v), causal=False,
                                         key_padding_bias=_t(bias))
    got = attention_ops.flash_attention(
        _t(_flat(q)), _t(_flat(k)), _t(_flat(v)), causal=False,
        key_padding_bias=_t(bias), num_heads=2)
    assert got.grad_fn is None          # no autograd: the bare forward
    assert torch.equal(got, want.reshape(4, 32, 16))
    with pytest.raises(ValueError, match='key_padding_bias must be'):
        attention_ops.flash_attention(_t(_flat(q)), _t(_flat(k)),
                                      _t(_flat(v)),
                                      key_padding_bias=_t(bias))
    with pytest.raises(ValueError, match='key_padding_bias must be'):
        attention_ops.flash_attention(_t(q), _t(k), _t(v),
                                      key_padding_bias=_t(bias[:, :5]))


@pytest.mark.parametrize('causal,biased', CASES, ids=IDS)
def test_plain_backward_equals_autograd_of_plain_forward(causal, biased):
    """`_flash_bwd_ref` is written as the kernels' arithmetic; autograd of
    `_attention_ref` is an independent derivation of the same gradient."""
    q, k, v, do, bias = _data(8, biased, (2, 2, 48, 16))
    tb = None if bias is None else _t(bias)
    args = [_t(_flat(a), grad=True) for a in (q, k, v)]
    o, lse = attention_ops._attention_ref(*args, SCALE, causal, tb, 2)
    want = torch.autograd.grad(o, args, _t(_flat(do)))
    got = attention_ops._flash_bwd_ref(
        *[a.detach() for a in args], o.detach(), lse.detach(),
        _t(_flat(do)), SCALE, causal, tb, 2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize('dh', [8, 48, 80, 96, 160, 192, 256])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_head_width_padding_is_exact(dh, dtype):
    """The card's wrappers run a head width outside the kernels' 16, 32,
    64, 128 and 256 by zero-padding q, k, v and dO along dh to the next of
    those (`_kernel_width`, `_pad_dh`) and slicing O, dQ, dK and dV back:
    the plain versions of the kernels on the padded operands, at the true
    width's scale, give the unpadded results (within 1e-6 of each output's
    largest magnitude: a longer sum of the same terms and zeros; bf16
    results are compared in their own rounding), and the padded columns
    are exactly 0. A width above 256 goes to the wide kernels' next
    multiple of 128; a width below 1 raises, as do operands of two
    widths."""
    q, k, v, do, bias = _data(9, True, (2, 2, 40, dh))
    q, k, v, do = (_t(_flat(a)).to(dtype) for a in (q, k, v, do))
    tb, scale = _t(bias), dh ** -0.5
    w = attention_ops._kernel_width(dh)
    assert w == {8: 16, 48: 64, 80: 128, 96: 128, 160: 256, 192: 256,
                 256: 256}[dh]
    o, lse = attention_ops._attention_ref(q, k, v, scale, True, tb, 2)
    want = (o,) + attention_ops._flash_bwd_ref(q, k, v, o, lse, do, scale,
                                               True, tb, 2)
    pq, pk, pv, pdo = attention_ops._pad_dh(w, q, k, v, do)
    po, plse = attention_ops._attention_ref(pq, pk, pv, scale, True, tb, 2)
    delta = attention_ops._delta(do, o)
    got = (po, attention_ops._bwd_dq_ref(pq, pk, pv, pdo, plse, delta, scale,
                                         True, tb, 2)) + \
        attention_ops._bwd_dkv_ref(pq, pk, pv, pdo, plse, delta, scale, True,
                                   tb, 2)
    torch.testing.assert_close(plse, lse, rtol=0, atol=1e-6)
    for g, wt in zip(got, want):
        assert g.shape[-1] == w
        assert torch.count_nonzero(g[..., dh:]) == 0
        g = attention_ops._unpad(dh, g)[0]
        tol = 1e-6 if dtype == torch.float32 else 2 ** -8
        assert float((g.float() - wt.float()).abs().max()) <= \
            tol * float(wt.float().abs().max())
    # above 256 the wide kernels take the next multiple of 128; below 1
    # nothing
    assert [attention_ops._kernel_width(d) for d in (257, 384, 512, 513)] \
        == [384, 384, 512, 640]
    with pytest.raises(ValueError, match='widths from 1 up'):
        attention_ops._kernel_width(0)
    with pytest.raises(ValueError, match='one head width'):
        attention_ops._pad_dh(w, q, k[..., :dh - 1])


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('dh', [320, 512, 1152])
def test_wide_head_width_matches_jax_grad(dh, dtype):
    """Head widths above 256 (the card's wide kernels; here their plain
    versions; 1152 is past the forward's group of four 128-wide column
    chunks): O and dQ, dK, dV of ``flash_attention`` against the JAX
    package's ``flash_attention(use_pallas='interpret')`` and ``jax.grad``,
    BH 2 (B 2, H 1), L 64, causal, with a key-padding bias; f32 at the
    file's tolerances, bf16 within 1e-2 of each output's largest
    magnitude (an element near a bf16 rounding boundary may land one bf16
    step away)."""
    q, k, v, ct, bias = _data(4, True, (2, 1, 64, dh))
    jdt = jnp.float32 if dtype == 'float32' else jnp.bfloat16
    jq, jk, jv, jct = (jnp.asarray(a).astype(jdt) for a in (q, k, v, ct))
    jb = jnp.asarray(bias)

    def jloss(a, b, c):
        o = jattn.flash_attention(a, b, c, causal=True, use_pallas='interpret',
                                  key_padding_bias=jb)
        return jnp.sum(o.astype(jnp.float32) * jct.astype(jnp.float32)), o
    (_, o_j), grads_j = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(jq, jk, jv)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        tdt).requires_grad_() for a in (jq, jk, jv))
    tct = torch.from_numpy(np.array(jct.astype(jnp.float32))).to(tdt)
    o = attention_ops.flash_attention(tq, tk, tv, causal=True,
                                      key_padding_bias=_t(bias))
    (o.float() * tct.float()).sum().backward()
    got = (o, tq.grad, tk.grad, tv.grad)
    want = (o_j,) + tuple(grads_j)
    for name, g, w in zip(('o', 'dq', 'dk', 'dv'), got, want):
        assert g.dtype == tdt and g.shape == q.shape, name
        g = g.detach().float().numpy()
        w = np.asarray(w.astype(jnp.float32))
        if dtype == 'float32':
            np.testing.assert_allclose(
                g, w, err_msg=name, **(FWD_TOL if name == 'o' else GRAD_TOL))
        else:
            assert np.abs(g - w).max() <= 1e-2 * np.abs(w).max(), name
