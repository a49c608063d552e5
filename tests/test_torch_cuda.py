"""paddle_tpu_torch's CUDA kernels against their plain PyTorch versions, on
the card, at ragged shapes the engine's own shapes do not reach (rows, keys
and widths that are not multiples of the tiles). Marked ``cuda``: each test
skips without a card; on one, run

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest imports jax, which the card's
machine need not have; this file imports only the port.) The four tests
that check which paths of the bf16 dQ and dK/dV kernels the cases and
chip_smoke.py's shapes reach follow the kernels' rules in Python and need
no card.

Tolerances: exact for the gather (a copy) and for Adam (the same
correctly rounded IEEE operations in the same order); 1e-4 absolute for the
other f32 kernels, whose sums run in another order than the plain
version's (1e-6 for the CE gradient, a probability times ct); the flash
backward's gradients (3xTF32 products on the tensor cores, summed tile by
tile) within 1e-4 of each tensor's largest magnitude, and bitwise equal
from one call to the next. The bf16 flash kernels (bf16 operands, float32
sums, P and dS rounded to bf16 before their products) within 1e-2 of each
output's largest magnitude of their plain versions, which round at the same
places but sum in another order, so that an element near a bf16 rounding
boundary may land one bf16 step (2^-8 of its magnitude) away; their LSE
within 1e-5 (float32 sums of float32 exponentials).
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.models import bert
from paddle_tpu_torch.models.transformer import (LMConfig, TransformerLM,
                                                 init_params)
from paddle_tpu_torch.ops import (attention_ops, ce_ops, embedding_ops,
                                  ffn_ops, kernel_tier, nn_ops,
                                  optimizer_ops)

import torch_activation_cases
import torch_loop_cases

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda', 0)


def _randn(dev, *shape, scale=1.0, seed=0):
    g = torch.Generator(device='cpu').manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to(dev)


def _err(a, b):
    return float((a - b).abs().max())


@pytest.mark.parametrize('V,D,n', [
    (1000, D, n) for D in (1, 3, 4, 16, 32, 128, 130, 512, 768, 8192)
    for n in (1, 1237, 13312)] + [(100000, 16, 13312), (1 << 20, 32, 13312)])
def test_embedding_gather_kernel(dev, V, D, n):
    """The gather against its plain version's bits at every row-group width
    (D 1 to 8192: one lane a row up to four warps a row, and a loop over
    column chunks), n of one row (the widest groups), a ragged last block
    and the CTR rows' 512 x 26 ids, also from their own tables ([100000,
    16] and [1048576, 32]); ids that clamp (below 0, at V, past V); without
    and with the bias; from a contiguous table and from one offset by a
    float, which takes the scalar path. One launch counted a call."""
    flat = _randn(dev, V * D + 1, seed=D)
    g = torch.Generator(device='cpu').manual_seed(n)
    ids = torch.randint(0, V, (n,), generator=g)
    ids[:3] = torch.tensor([-7, V, V + 60])[:n]
    ids = ids.to(dev)
    bias = _randn(dev, D, seed=1)
    for w in (flat[:V * D].view(V, D), flat[1:].view(V, D)):
        for b in (None, bias):
            before = kernel_tier.launch_counts()['embedding_gather']
            got = embedding_ops.embedding_gather(w, ids, b)
            torch.cuda.synchronize()
            assert kernel_tier.launch_counts()['embedding_gather'] == \
                before + 1
            assert torch.equal(got, embedding_ops._gather_ref(w, ids, b))


# widths up to 4096 stay in registers; 6144 and 8192 take the wide kernel
@pytest.mark.parametrize('n,D', [(1, 96), (13, 512), (37, 1000), (5, 4096),
                                 (9, 6144), (3, 8192)])
def test_fused_ln_residual_kernel(dev, n, D):
    x, r = _randn(dev, n, D), _randn(dev, n, D, seed=1)
    sc, b = 1 + _randn(dev, D, scale=0.1, seed=2), _randn(dev, D, seed=3)
    got = nn_ops.fused_ln_residual(x, r, sc, b, 1e-5)
    want = nn_ops._ln_res_ref(x, r, sc, b, 1e-5)
    torch.cuda.synchronize()
    assert max(_err(g, w) for g, w in zip(got, want)) <= 1e-4


@pytest.mark.parametrize('L,dh,causal', [(1, 64, True), (37, 64, True),
                                         (100, 32, True), (70, 128, False),
                                         (65, 16, True)])
def test_flash_attention_kernel(dev, L, dh, causal):
    q, k, v = (_randn(dev, 3, L, dh, seed=s) for s in range(3))
    o, lse = attention_ops.flash_attention(q, k, v, causal=causal,
                                           return_lse=True)
    o_ref, lse_ref = attention_ops._attention_ref(q, k, v, dh ** -0.5,
                                                  causal)
    torch.cuda.synchronize()
    assert _err(o, o_ref) <= 1e-4 and _err(lse, lse_ref) <= 1e-4


def _padding_bias(dev, B, L, all_padded):
    """[B, L] bias: element i keeps its first L - i*L//(2B) - 1 keys (at
    least one); with ``all_padded`` element 0 keeps none."""
    bias = torch.zeros(B, L)
    for i in range(B):
        bias[i, max(1, L - i * L // (2 * B) - 1):] = -1e9
    if all_padded:
        bias[0, :] = -1e9
    return bias.to(dev)


@pytest.mark.parametrize('all_padded', [False, True],
                         ids=['tails', 'one-element-all-padded'])
@pytest.mark.parametrize('causal', [False, True], ids=['full', 'causal'])
@pytest.mark.parametrize('L,dh', [(1, 64), (63, 16), (65, 32), (200, 64),
                                  (130, 128)])
def test_flash_kernels_forward_and_backward(dev, L, dh, causal, all_padded):
    """The three flash kernels, with and without the key-padding bias, at
    lengths that are not multiples of the 64-row tiles."""
    B, H = 3, 2
    q, k, v, do = (_randn(dev, B * H, L, dh, seed=s) for s in range(4))
    scale = dh ** -0.5
    for bias in (None, _padding_bias(dev, B, L, all_padded)):
        before = kernel_tier.launch_counts()
        o, lse = attention_ops._flash_fwd(q, k, v, scale, causal, bias, H)
        dq, dk, dv = attention_ops._flash_bwd(q, k, v, o, lse, do, scale,
                                              causal, bias, H)
        torch.cuda.synchronize()
        after = kernel_tier.launch_counts()
        for name in ('flash_attention', 'flash_attention_bwd_dq',
                     'flash_attention_bwd_dkv'):
            assert after[name] == before[name] + 1
        o_ref, lse_ref = attention_ops._attention_ref(q, k, v, scale, causal,
                                                      bias, H)
        # the backward's plain version on the kernel's own o and lse
        want = attention_ops._flash_bwd_ref(q, k, v, o, lse, do, scale,
                                            causal, bias, H)
        live = slice(H if bias is not None and all_padded else 0, None)
        assert _err(o, o_ref) <= 1e-4
        assert _err(lse[live], lse_ref[live]) <= 1e-4
        for g, w in zip((dq, dk, dv), want):
            assert torch.isfinite(g).all()
            # inputs are O(1): at L 1 the gradients are rounding noise
            # around 0, so the limit does not shrink below 1e-4
            assert _err(g, w) <= 1e-4 * max(1.0, float(w.abs().max()))
        if bias is not None and all_padded:
            # every key of element 0 is dropped: exact zeros, and an LSE
            # near -1e9 + log(1e-30), of which only the sign is checked
            for t in (o, dq, dk, dv):
                assert not t[:H].any()
            assert bool((lse[:H] < -1e8).all())


def test_flash_autograd_function_on_the_card(dev):
    """`flash_attention` on tensors that require grad goes through the
    three kernels and gives the plain version's gradients; under no_grad it
    launches the forward alone."""
    B, H, L, dh = 2, 2, 70, 32
    q, k, v, do = (_randn(dev, B, H, L, dh, seed=s) for s in range(4))
    bias = _padding_bias(dev, B, L, False)
    grads = {}
    for d in (dev, torch.device('cpu')):
        args = [t.detach().to(d).requires_grad_() for t in (q, k, v)]
        kernel_tier.reset_counts()
        out = attention_ops.flash_attention(
            *[a.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
              for a in args], causal=False, key_padding_bias=bias.to(d))
        out.backward(do.to(d))
        grads[d.type] = [a.grad.cpu() for a in args]
        counts = kernel_tier.launch_counts()
        n = 1 if d.type == 'cuda' else 0
        assert (counts['flash_attention'], counts['flash_attention_bwd_dq'],
                counts['flash_attention_bwd_dkv']) == (n, n, n)
    for g, w in zip(grads['cuda'], grads['cpu']):
        assert _err(g, w) <= 1e-4 * float(w.abs().max())
    kernel_tier.reset_counts()
    with torch.no_grad():
        attention_ops.flash_attention(q.detach().requires_grad_(), k, v)
    counts = kernel_tier.launch_counts()
    assert counts['flash_attention'] == 1
    assert counts['flash_attention_bwd_dq'] == 0


def test_flash_attention_kernel_rejects_bias_and_odd_head_width(dev):
    """A bias of the wrong shape or on another device raises, as does a
    head width the kernels do not take; a well-formed bias is taken."""
    q = _randn(dev, 1, 2, 8, 64)
    with pytest.raises(ValueError, match='key_padding_bias must be'):
        attention_ops.flash_attention(q, q, q, key_padding_bias=torch.zeros(
            2, 8, device=dev))
    with pytest.raises(RuntimeError, match='all lie on one CUDA device'):
        attention_ops.flash_attention(q, q, q,
                                      key_padding_bias=torch.zeros(1, 8))
    out = attention_ops.flash_attention(q, q, q, key_padding_bias=torch.zeros(
        1, 8, device=dev))
    assert _err(out, attention_ops.flash_attention(q, q, q)) == 0
    # widths up to 256 run zero-padded (test_flash_kernels_take_any_head_
    # width); above 256 the wide kernels take them, padded to 384 here;
    # a width below 1 raises
    q = _randn(dev, 2, 8, 257)
    want = attention_ops.flash_attention(q.cpu(), q.cpu(), q.cpu())
    assert _err(attention_ops.flash_attention(q, q, q).cpu(), want) <= 1e-4
    with pytest.raises(ValueError, match='widths from 1 up'):
        attention_ops.flash_attention(q[..., :0], q[..., :0], q[..., :0],
                                      scale=1.0)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('dh', [8, 48, 80, 96, 160, 192, 256])
def test_flash_kernels_take_any_head_width(dev, dh, dtype):
    """The three flash kernels (f32 and bf16) at head widths between their
    instantiations, which the wrappers zero-pad to the next one, and at
    256 (each block one half of the output columns), on a small shape
    (L 100, off every tile) with the key-padding bias, causal and not:
    each launched once a call and within its tolerance of its plain
    version at the true width (f32: O and LSE 1e-4, gradients 1e-4 of
    their largest magnitude; bf16: O and gradients 1e-2 of theirs, LSE
    1e-5)."""
    B, H, L = 3, 2, 100
    q, k, v, do = (_randn(dev, B * H, L, dh, seed=s).to(dtype)
                   for s in range(4))
    for causal in (True, False):
        _check_head_width(q, k, v, do, dh, causal,
                          _padding_bias(dev, B, L, False), H)


def _check_head_width(q, k, v, do, dh, causal, bias, H):
    dtype = q.dtype
    args = (dh ** -0.5, causal, bias, H)
    before = kernel_tier.launch_counts()
    o, lse = attention_ops._flash_fwd(q, k, v, *args)
    dq, dk, dv = attention_ops._flash_bwd(q, k, v, o, lse, do, *args)
    torch.cuda.synchronize()
    after = kernel_tier.launch_counts()
    names = BF16_FLASH if dtype == torch.bfloat16 else (
        'flash_attention', 'flash_attention_bwd_dq', 'flash_attention_bwd_dkv')
    assert [after[n] - before[n] for n in names] == [1, 1, 1]
    for t in (o, dq, dk, dv):
        assert t.shape == q.shape and t.dtype == dtype and t.is_contiguous()
    o_ref, lse_ref = attention_ops._attention_ref(q, k, v, *args)
    want = attention_ops._flash_bwd_ref(q, k, v, o, lse, do, *args)
    if dtype == torch.float32:
        assert _err(o, o_ref) <= 1e-4 and _err(lse, lse_ref) <= 1e-4
        tol = 1e-4
    else:
        assert _err(lse, lse_ref) <= 1e-5
        assert _err(o.float(), o_ref.float()) <= \
            1e-2 * float(o_ref.float().abs().max())
        tol = 1e-2
    for g, w in zip((dq, dk, dv), want):
        g, w = g.float(), w.float()
        assert torch.isfinite(g).all()
        assert _err(g, w) <= tol * max(1.0, float(w.abs().max()))


def _ffn_operands(dev, n, d, f, with_mask=False):
    x = _randn(dev, n, d)
    w1, b1 = _randn(dev, d, f, scale=0.05, seed=1), _randn(dev, f, seed=2)
    w2, b2 = _randn(dev, f, d, scale=0.05, seed=3), _randn(dev, d, seed=4)
    mask = (_randn(dev, n, d, seed=5) > 0).float() if with_mask else None
    return x, w1, b1, w2, b2, mask


# row counts on both sides of the skinny route's limit (8) and of its
# kernel's 32-row ceiling, with and without a split K; widths that are not
# multiples of 4 (the 4-byte copies)
@pytest.mark.parametrize('n,d,f,with_mask', [
    (1, 64, 128, False), (70, 100, 200, True), (8, 512, 2048, False),
    (300, 768, 3072, True), (16, 512, 2048, True), (32, 512, 2048, True),
    (33, 512, 2048, True), (64, 512, 2048, True), (3, 30, 50, True),
    (37, 30, 50, True), (300, 30, 50, True)])
def test_fused_ffn_kernel(dev, n, d, f, with_mask):
    args = _ffn_operands(dev, n, d, f, with_mask)
    y, pre1 = ffn_ops.fused_ffn_core(*args, want_pre1=True)
    y_ref, pre1_ref = ffn_ops._ffn_ref(*args)
    torch.cuda.synchronize()
    assert _err(y, y_ref) <= 1e-4 and _err(pre1, pre1_ref) <= 1e-4


@pytest.mark.parametrize('n', [17, 32])
def test_fused_ffn_skinny_kernel_takes_32_rows(dev, monkeypatch, n):
    """The skinny kernel's 32-row form, which the route's limit of 16 leaves
    to measurements: with the limit raised it is right too."""
    monkeypatch.setattr(ffn_ops, '_SKINNY_MAX_ROWS', 32)
    args = _ffn_operands(dev, n, 512, 2048, with_mask=True)
    assert ffn_ops._plan(n, 512, 2048, 512)[0] == 'skinny'
    y, pre1 = ffn_ops.fused_ffn_core(*args, want_pre1=True)
    y_ref, pre1_ref = ffn_ops._ffn_ref(*args)
    torch.cuda.synchronize()
    assert _err(y, y_ref) <= 1e-4 and _err(pre1, pre1_ref) <= 1e-4


@pytest.mark.parametrize('n', [8, 128, 4096])
def test_fused_ffn_kernel_is_deterministic_and_row_independent(dev, n):
    """Two calls give the same bits on every route (skinny, split K, plain
    tiles), and row 0's output does not move when the other rows change."""
    x, w1, b1, w2, b2, _ = _ffn_operands(dev, n, 512, 2048)
    first = ffn_ops.fused_ffn_core(x, w1, b1, w2, b2, want_pre1=True)
    second = ffn_ops.fused_ffn_core(x, w1, b1, w2, b2, want_pre1=True)
    other = x.clone()
    other[1:] = _randn(dev, n - 1, 512, seed=9)
    moved = ffn_ops.fused_ffn_core(other, w1, b1, w2, b2, want_pre1=True)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    for a, b in zip(first, moved):
        assert torch.equal(a[0], b[0])


@pytest.mark.parametrize('L', [1, 37, 256, 300])
def test_flash_attention_kernel_dh128_with_bias(dev, L):
    """The three kernels at head width 128 with the padding bias, causal
    and not: the backward streams 32-row tiles there and sums each tile's
    product in two 64-column passes."""
    B, H, dh = 2, 3, 128
    q, k, v, do = (_randn(dev, B * H, L, dh, seed=s) for s in range(4))
    bias = _padding_bias(dev, B, L, False)
    for causal in (False, True):
        args = (dh ** -0.5, causal, bias, H)
        o, lse = attention_ops._flash_fwd(q, k, v, *args)
        o_ref, lse_ref = attention_ops._attention_ref(q, k, v, *args)
        grads = attention_ops._flash_bwd(q, k, v, o, lse, do, *args)
        want = attention_ops._flash_bwd_ref(q, k, v, o, lse, do, *args)
        torch.cuda.synchronize()
        assert _err(o, o_ref) <= 1e-4 and _err(lse, lse_ref) <= 1e-4
        for g, w in zip(grads, want):
            assert torch.isfinite(g).all()
            assert _err(g, w) <= 1e-4 * max(1.0, float(w.abs().max()))


@pytest.mark.parametrize('bh,L', [(8, 256), (40, 100), (256, 128)],
                         ids=['16-row-tiles', '32-row-tiles', '64-row-tiles'])
def test_flash_attention_kernel_is_deterministic(dev, bh, L):
    """Two calls of the forward, of the dQ kernel and of the dK/dV kernel
    give the same bits, with and without the padding bias, whatever rows a
    block owns."""
    q, k, v, do = (_randn(dev, bh, L, 64, seed=s) for s in range(4))
    bias = _padding_bias(dev, bh // 4, L, True)
    for b in (None, bias):
        args = (0.125, b is None, b, 4)
        first = attention_ops._flash_fwd(q, k, v, *args)
        second = attention_ops._flash_fwd(q, k, v, *args)
        want = attention_ops._attention_ref(q, k, v, *args)
        ins = (q, k, v, do, first[1], (do * first[0]).sum(dim=-1)) + args
        dq = [attention_ops._flash_bwd_dq(*ins) for _ in range(2)]
        dkv = [attention_ops._flash_bwd_dkv(*ins) for _ in range(2)]
        want_bwd = (attention_ops._bwd_dq_ref(*ins),) + \
            attention_ops._bwd_dkv_ref(*ins)
        torch.cuda.synchronize()
        for x, y in zip(first + (dq[0],) + dkv[0], second + (dq[1],) + dkv[1]):
            assert torch.equal(x, y)
        assert _err(first[0], want[0]) <= 1e-4
        for g, w in zip((dq[0],) + dkv[0], want_bwd):
            assert _err(g, w) <= 1e-4 * float(w.abs().max())


@pytest.mark.parametrize('n,V', [(1, 32000), (37, 1001), (300, 4096),
                                 (5, 3), (40, 30522), (128, 2)])
def test_softmax_ce_kernels(dev, n, V):
    x = _randn(dev, n, V, scale=3.0)
    g = torch.Generator(device='cpu').manual_seed(7)
    lab = torch.randint(0, V, (n,), generator=g)
    lab[0] = -100                       # ignored
    if n > 2:
        lab[1] = V + 3                  # out of range: picks nothing
        lab[2] = -7
    lab = lab.to(dev)
    ct = _randn(dev, n, seed=8)
    before = kernel_tier.launch_counts()
    loss, lse = ce_ops._ce_fwd(x, lab, -100)
    dx = ce_ops._ce_bwd(x, lab, lse, ct, -100)
    loss_ref, lse_ref = ce_ops._ce_fwd_ref(x, lab, -100)
    dx_ref = ce_ops._ce_bwd_ref(x, lab, lse, ct, -100)   # the same inputs
    torch.cuda.synchronize()
    after = kernel_tier.launch_counts()
    assert after['softmax_ce_fwd'] == before['softmax_ce_fwd'] + 1
    assert after['softmax_ce_bwd'] == before['softmax_ce_bwd'] + 1
    assert _err(loss, loss_ref) <= 1e-4 and _err(lse, lse_ref) <= 1e-4
    assert _err(dx, dx_ref) <= 1e-6
    assert loss[0] == 0 and not dx[0].any()


@pytest.mark.parametrize('n,D', [(13, 256), (3, 4096), (9, 6144), (37, 1000),
                                 (64, 512)])
def test_fused_ln_residual_backward_kernel(dev, n, D):
    x, r = _randn(dev, n, D), _randn(dev, n, D, seed=1)
    sc = 1 + _randn(dev, D, scale=0.1, seed=2)
    dy, ds = _randn(dev, n, D, seed=3), _randn(dev, n, D, seed=4)
    _, s, m, rs = nn_ops._ln_res_ref(x, r, sc, torch.zeros_like(sc), 1e-5)
    before = kernel_tier.launch_counts()['fused_ln_residual_bwd']
    dx = nn_ops._ln_res_bwd(s, m, rs, sc, dy, ds)
    want = nn_ops._ln_res_bwd_ref(s, m, rs, sc, dy, ds)
    torch.cuda.synchronize()
    assert kernel_tier.launch_counts()['fused_ln_residual_bwd'] == before + 1
    assert _err(dx, want) <= 1e-4


@pytest.mark.parametrize('sizes', [[1, 3, 5, 1023, 4097],
                                   [7] * 50 + [130, 2],
                                   [512 * 2048, 512, 33]])
def test_fused_adam_kernel(dev, sizes):
    def state(seed):
        return [_randn(dev, k, seed=seed + i) for i, k in enumerate(sizes)]
    p, g = state(10), state(100)
    m1 = [t * 0.1 for t in state(200)]
    m2 = [t.abs() * 0.01 for t in state(300)]
    # a view at an odd offset takes the scalar path
    big = _randn(dev, sizes[0] + 1, seed=9)
    p[0] = big[1:]
    b1p = [torch.full((1,), 0.9 ** 3, device=dev) for _ in sizes]
    b2p = [torch.full((1,), 0.999 ** 3, device=dev) for _ in sizes]
    lr = torch.full((1,), 1e-3, device=dev)
    ref = [[t.clone() for t in ts] for ts in (p, m1, m2, b1p, b2p)]
    before = kernel_tier.launch_counts()['fused_adam']
    optimizer_ops.fused_adam(p, g, m1, m2, b1p, b2p, lr)
    rp, rm1, rm2, rb1, rb2 = ref
    optimizer_ops._fused_adam_ref(rp, g, rm1, rm2, rb1, rb2, lr, 0.9, 0.999,
                                  1e-8)
    torch.cuda.synchronize()
    assert kernel_tier.launch_counts()['fused_adam'] == before + 1
    for got, want in ((p, rp), (m1, rm1), (m2, rm2), (b1p, rb1),
                      (b2p, rb2)):
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_flash_training_on_the_card_matches_unfused(dev):
    """Flash-on training (attention dropout 0) on the card runs the three
    flash kernels, once a layer each, and matches the unfused branch."""
    from paddle_tpu_torch.optimizer import TensorAdam
    kw = dict(vocab_size=64, seq_len=16, d_model=64, n_head=2, n_layer=2,
              d_ff=64, dropout=0.0)
    g = torch.Generator(device='cpu').manual_seed(3)
    tok = torch.randint(0, 64, (3, 16), generator=g).to(dev)
    res = {}
    for flash in (True, False):
        cfg = LMConfig(use_flash_attention=flash, **kw)
        m = TransformerLM(cfg, init_params(cfg, 0, dev), 16)
        kernel_tier.reset_counts()
        loss = m.loss(tok, tok)
        loss.backward()
        torch.cuda.synchronize()
        counts = kernel_tier.launch_counts()
        n = 2 if flash else 0
        assert (counts['flash_attention'], counts['flash_attention_bwd_dq'],
                counts['flash_attention_bwd_dkv']) == (n, n, n)
        res[flash] = (float(loss.detach()),
                      m.p['layer_0.attn.qkv.w'].grad.clone())
        TensorAdam(m.p, 1e-3, fuse=True).step()
    assert abs(res[True][0] - res[False][0]) <= 1e-5
    assert _err(res[True][1], res[False][1]) <= \
        1e-4 * float(res[False][1].abs().max())


def test_bert_step_goes_through_the_kernels(dev):
    """A BERT training step on the card launches every kernel of its path
    (the flash three once a layer, with the padding bias), and its
    inference losses equal the CPU's."""
    import numpy as np
    from paddle_tpu_torch.optimizer import TensorAdam
    cfg = bert.BertConfig(vocab_size=130, seq_len=24, d_model=64, n_head=2,
                          n_layer=2, d_ff=128, attn_dropout=0.0,
                          max_predictions=3)
    feed = bert.make_pretrain_batch(cfg, 4, np.random.RandomState(0))
    for i, keep in enumerate((24, 9, 17, 1)):
        feed['input_mask'][i, keep:] = 0.0
    params = bert.init_params(cfg, 0, 'cpu')
    cpu = bert.BertPretrain(cfg, params)
    m = bert.BertPretrain(cfg, {k: v.to(dev) for k, v in params.items()})
    on = lambda d: {k: torch.from_numpy(v).to(d) for k, v in feed.items()}
    with torch.no_grad():
        want = cpu.loss(is_test=True, **on('cpu'))
        got = m.loss(is_test=True, **on(dev))
    for a, b in zip(got, want):
        assert abs(float(a) - float(b)) <= 1e-4
    opt = TensorAdam(m.p, 1e-3, fuse=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    kernel_tier.reset_counts()
    loss = opt.minimize(m.loss(generator=gen, **on(dev))[0])
    torch.cuda.synchronize()
    counts = kernel_tier.launch_counts()
    assert torch.isfinite(loss)
    for name in ('flash_attention', 'flash_attention_bwd_dq',
                 'flash_attention_bwd_dkv', 'fused_ffn'):
        assert counts[name] == 2, name
    assert counts['embedding_gather'] == 2
    assert counts['softmax_ce_fwd'] == 2 and counts['softmax_ce_bwd'] == 2
    assert counts['fused_ln_residual'] == 5
    assert counts['fused_ln_residual_bwd'] == 5
    assert counts['fused_adam'] >= 1


def test_training_step_goes_through_the_kernels(dev):
    from paddle_tpu_torch.optimizer import TensorAdam
    cfg = LMConfig(vocab_size=300, seq_len=24, d_model=64, n_head=2,
                   n_layer=2, d_ff=128)
    m = TransformerLM(cfg, init_params(cfg, 0, dev), 24)
    opt = TensorAdam(m.p, 1e-3, fuse=True)
    g = torch.Generator(device=dev).manual_seed(0)
    tok = torch.randint(0, 300, (3, 24), device=dev, generator=g)
    kernel_tier.reset_counts()
    loss = opt.minimize(m.loss(tok, tok, g))
    torch.cuda.synchronize()
    counts = kernel_tier.launch_counts()
    assert torch.isfinite(loss)
    assert counts['fused_ln_residual'] == 5
    assert counts['fused_ln_residual_bwd'] == 5
    for k in ('embedding_gather', 'fused_ffn', 'softmax_ce_fwd',
              'softmax_ce_bwd', 'fused_adam'):
        assert counts[k] >= 1, k
    assert counts['flash_attention'] == 0


BF16_FLASH = ('flash_attention_bf16', 'flash_attention_bf16_bwd_dq',
              'flash_attention_bf16_bwd_dkv')


def _bf16_flash_case(dev, B, H, L, dh, causal, bias):
    """The three bf16 kernels and their plain versions on one set of bf16
    inputs: (kernel outputs o, lse, dq, dk, dv; plain ones; launches)."""
    q, k, v, do = (_randn(dev, B * H, L, dh, seed=s).to(torch.bfloat16)
                   for s in range(4))
    args = (dh ** -0.5, causal, bias, H)
    before = kernel_tier.launch_counts()
    o, lse = attention_ops._flash_fwd(q, k, v, *args)
    dq, dk, dv = attention_ops._flash_bwd(q, k, v, o, lse, do, *args)
    torch.cuda.synchronize()
    after = kernel_tier.launch_counts()
    o_ref, lse_ref = attention_ops._attention_ref(q, k, v, *args)
    delta = attention_ops._delta(do, o)
    want = (attention_ops._bwd_dq_ref(q, k, v, do, lse, delta, *args),) + \
        attention_ops._bwd_dkv_ref(q, k, v, do, lse, delta, *args)
    launched = {n: after[n] - before[n] for n in after}
    return (o, lse, dq, dk, dv), (o_ref, lse_ref) + want, launched


@pytest.mark.parametrize('all_padded', [False, True],
                         ids=['tails', 'one-element-all-padded'])
@pytest.mark.parametrize('causal', [False, True], ids=['full', 'causal'])
@pytest.mark.parametrize('L,dh', [(1, 64), (63, 16), (65, 32), (200, 64),
                                  (130, 128)])
def test_flash_bf16_kernels_forward_and_backward(dev, L, dh, causal,
                                                 all_padded):
    """The three bf16 flash kernels against their plain versions, with and
    without the key-padding bias, at lengths that are not multiples of the
    tiles; a wholly padded element gives exact zeros."""
    B, H = 3, 2
    for bias in (None, _padding_bias(dev, B, L, all_padded)):
        got, want, launched = _bf16_flash_case(dev, B, H, L, dh, causal, bias)
        assert [launched[n] for n in BF16_FLASH] == [1, 1, 1]
        assert launched['flash_attention'] == 0
        assert launched['flash_attention_bwd_dq'] == 0
        o, lse, dq, dk, dv = got
        assert all(t.dtype == torch.bfloat16 for t in (o, dq, dk, dv))
        live = slice(H if bias is not None and all_padded else 0, None)
        assert _err(lse[live], want[1][live]) <= 1e-5
        for g, w in zip((o, dq, dk, dv), want[:1] + want[2:]):
            g, w = g.float(), w.float()
            assert torch.isfinite(g).all()
            assert _err(g, w) <= 1e-2 * max(1.0, float(w.abs().max()))
        if bias is not None and all_padded:
            for t in (o, dq, dk, dv):
                assert not t[:H].any()


@pytest.mark.parametrize('bh,L', [(8, 256), (40, 100), (256, 128)],
                         ids=['16-row-tiles', '32-row-tiles', '64-row-tiles'])
def test_flash_bf16_kernels_are_deterministic(dev, bh, L):
    """Two calls of each bf16 kernel give the same bits, with and without
    the padding bias, whatever rows a block owns."""
    q, k, v, do = (_randn(dev, bh, L, 64, seed=s).to(torch.bfloat16)
                   for s in range(4))
    bias = _padding_bias(dev, bh // 4, L, True)
    for b in (None, bias):
        args = (0.125, b is None, b, 4)
        first = attention_ops._flash_fwd(q, k, v, *args)
        second = attention_ops._flash_fwd(q, k, v, *args)
        ins = (q, k, v, do, first[1], attention_ops._delta(do, first[0])) \
            + args
        dq = [attention_ops._flash_bwd_dq(*ins) for _ in range(2)]
        dkv = [attention_ops._flash_bwd_dkv(*ins) for _ in range(2)]
        torch.cuda.synchronize()
        for x, y in zip(first + (dq[0],) + dkv[0], second + (dq[1],) + dkv[1]):
            assert torch.equal(x, y)


BF16_FWD_LENGTHS = (127, 128, 129, 256, 383, 512)


def _bf16_fwd_plans(dh, causal):
    """{query rows a block: query rows a warp} of the bf16 forward's plans
    at head width ``dh``: 32 rows a warp at dh <= 64 without causal, else
    16; at dh 256 two warps a block at least."""
    if dh <= 64 and not causal:
        return {128: 32, 64: 32, 32: 16, 16: 16}
    if dh > 128:
        return {64: 16, 32: 16}
    return {64: 16, 32: 16, 16: 16}


BF16_FWD_PLANS = [(dh, causal, rows) for dh in (16, 32, 64, 128, 256)
                  for causal in (False, True)
                  for rows in _bf16_fwd_plans(dh, causal)]


def _bh_for_rows(rows, L, dh):
    """A batch x heads at which the bf16 forward takes its plan of ``rows``
    query rows a block: the fewest whose blocks (two a row tile at dh 256)
    give each of the card's 132 SMs one (3 for the 16-row plan, which takes
    what fills nothing)."""
    halves = 2 if dh > 128 else 1
    return 3 if rows == 16 else -(-132 // (halves * -(-L // rows)))


def _tile_bias(dev, bh, L):
    """[bh, L] key bias (-1e9 drops a key) whose dropped keys fill key tile
    1 (keys 64-127), touch tile 2 (key 130) and, in every fourth element,
    tile 0 (key 3) and the last tile (the last 37 keys), and miss the other
    tiles; element 0 keeps no key."""
    bias = torch.zeros(bh, L)
    bias[:, 64:128] = -1e9
    bias[:, 130:131] = -1e9
    bias[1::4, 3] = -1e9
    bias[1::4, L - 37:] = -1e9
    bias[0] = -1e9
    return bias.to(dev)


def _tile_paths(L, causal, rows_block, rows_warp, bias_row):
    """The paths that the bf16 forward's warps take over the 64-key tiles
    of one head whose key bias is ``bias_row`` (a list; None for no bias),
    by the kernel's rule: 'interior' (a tile below L, under causal at or
    below the warp's first row, no key dropped), 'dropped' (such a tile
    with a dropped key), 'diagonal' (a causal tile below L that crosses the
    warp's rows, no key dropped) and 'edge' (the others)."""
    paths = set()
    for q0 in range(0, L, rows_block):
        last_row = min(q0 + rows_block, L) - 1
        nk = last_row // 64 + 1 if causal else -(-L // 64)
        for w0 in range(q0, min(q0 + rows_block, L), rows_warp):
            warp_last = min(w0 + rows_warp - 1, L - 1)
            for k0 in range(0, 64 * nk, 64):
                if causal and k0 > warp_last:
                    continue
                dropped = bias_row is not None and \
                    min(bias_row[k0:k0 + 64]) <= -1e8
                if k0 + 64 > L or (causal and k0 + 63 > w0):
                    paths.add('diagonal' if k0 + 64 <= L and not dropped
                              else 'edge')
                else:
                    paths.add('dropped' if dropped else 'interior')
    return paths


@pytest.mark.parametrize('L', BF16_FWD_LENGTHS)
@pytest.mark.parametrize('dh,causal,rows', BF16_FWD_PLANS)
def test_flash_bf16_forward_plans_and_tile_paths(dev, dh, causal, rows, L):
    """The bf16 forward in each of its plans (query rows a block and a
    warp, chosen by the grid's size and causal), at lengths at and around
    the 128-row and 64-key tile edges, with no bias and with one whose
    dropped keys fill, touch and miss key
    tiles: O within 1e-2 of its largest magnitude and LSE within 1e-5 of
    the plain version (on the rows that keep a key), the element that
    keeps no key exactly 0, and two calls bitwise equal. (The raw-product
    form runs at 16 rows a warp without a bias.)"""
    bh = _bh_for_rows(rows, L, dh)
    q, k, v = (_randn(dev, bh, L, dh, seed=s).to(torch.bfloat16)
               for s in range(3))
    for bias in (None, _tile_bias(dev, bh, L)):
        args = (dh ** -0.5, causal, bias, 1)
        rows_warp = _bf16_fwd_plans(dh, causal)[rows]
        assert attention_ops._bf16_fwd_plan(
            bh, L, dh, causal, bias is not None, args[0]) == \
            (rows, rows_warp, bias is None and rows_warp == 16)
        o, lse = attention_ops._flash_fwd(q, k, v, *args)
        again = attention_ops._flash_fwd(q, k, v, *args)
        torch.cuda.synchronize()
        o_ref, lse_ref = attention_ops._attention_ref(q, k, v, *args)
        live = slice(0 if bias is None else 1, None)
        assert _err(lse[live], lse_ref[live]) <= 1e-5
        o, o_ref = o.float(), o_ref.float()
        assert torch.isfinite(o).all()
        assert _err(o, o_ref) <= 1e-2 * max(1.0, float(o_ref.abs().max()))
        if bias is not None:
            assert not o[0].any()
        assert torch.equal(again[0].float(), o) and torch.equal(again[1], lse)


def test_flash_bf16_forward_cases_reach_every_plan_and_tile_path(dev):
    """The cases above take every plan of every head width, and in each
    plan every tile path (by the kernel's rule in ``_tile_paths``): the
    diagonal one under causal alone."""
    for dh, causal, rows in BF16_FWD_PLANS:
        rows_warp = _bf16_fwd_plans(dh, causal)[rows]
        reached = set()
        for L in BF16_FWD_LENGTHS:
            bh = _bh_for_rows(rows, L, dh)
            for biased in (False, True):
                assert attention_ops._bf16_fwd_plan(
                    bh, L, dh, causal, biased, dh ** -0.5) == \
                    (rows, rows_warp, not biased and rows_warp == 16)
            rows_bias = set(map(tuple, _tile_bias('cpu', bh, L).tolist()))
            for row in [None] + sorted(rows_bias):
                reached |= _tile_paths(L, causal, rows, rows_warp, row)
        want = {'interior', 'dropped', 'edge'} | \
            ({'diagonal'} if causal else set())
        assert reached == want, (dh, causal, rows)


@pytest.mark.parametrize('scale', [-0.125, 0.0, 2e4],
                         ids=['negative', 'zero', 'huge'])
def test_flash_bf16_forward_takes_any_scale(dev, scale):
    """Without a bias but with a scale that the raw-product form does not
    take (not in (0, 1e4)), the forward scales and masks each score as with
    a bias: O within 1e-2 of its largest magnitude, LSE within 1e-5 of its
    magnitude (2e4 x the products reaches 1e5)."""
    bh, L, dh = 6, 200, 64
    q, k, v = (_randn(dev, bh, L, dh, scale=0.1, seed=s).to(torch.bfloat16)
               for s in range(3))
    for causal in (False, True):
        args = (scale, causal, None, 1)
        assert not attention_ops._bf16_fwd_plan(bh, L, dh, causal, False,
                                                scale)[2]
        o, lse = attention_ops._flash_fwd(q, k, v, *args)
        torch.cuda.synchronize()
        o_ref, lse_ref = attention_ops._attention_ref(q, k, v, *args)
        o, o_ref = o.float(), o_ref.float()
        assert _err(o, o_ref) <= 1e-2 * max(1.0, float(o_ref.abs().max()))
        assert _err(lse, lse_ref) <= 1e-5 * max(1.0,
                                                float(lse_ref.abs().max()))


def test_flash_bf16_forward_drops_at_exactly_minus_1e8(dev):
    """A key whose bias is exactly -1e8 is dropped and one at -9.9e7 kept,
    in rows whose every key carries one of the two (so that the kept keys
    set the row's max), in interior, dropped-key and edge tiles. Scores
    this small against the bias round away in float32, so O is the mean of
    the kept keys' V: within 1e-2 of its largest magnitude; LSE (about
    -9.9e7, where float32 steps by 8) within one step of its magnitude."""
    bh, L, dh = 4, 200, 64
    q = _randn(dev, bh, L, dh, scale=1e-2).to(torch.bfloat16)
    k, v = (_randn(dev, bh, L, dh, seed=s).to(torch.bfloat16)
            for s in (1, 2))
    bias = torch.full((bh, L), -9.9e7)
    bias[0, 1::2] = -1e8           # every other key, in every tile
    bias[1, 64:128] = -1e8         # fills tile 1
    bias[2, :] = -1e8
    bias[2, 5] = -9.9e7            # keeps one key
    bias[3, 130] = -1e8            # touches tile 2
    bias = bias.to(dev)
    for causal in (False, True):
        args = (0.125, causal, bias, 1)
        o, lse = attention_ops._flash_fwd(q, k, v, *args)
        torch.cuda.synchronize()
        o_ref, lse_ref = attention_ops._attention_ref(q, k, v, *args)
        o, o_ref = o.float(), o_ref.float()
        assert _err(o, o_ref) <= 1e-2 * float(o_ref.abs().max())
        live = slice(5, None) if causal else slice(None)  # row 5 sees key 5
        assert float((lse - lse_ref)[:, live].abs().max()) <= \
            2 ** -23 * float(lse_ref.abs().max())
        # element 2's rows see only key 5: its V row, to a bf16 step
        v5 = v[2, 5].float()
        assert _err(o[2, 5:], v5.expand(L - 5, dh)) <= \
            2 ** -8 * float(v5.abs().max())


BF16_DKV_LENGTHS = (1, 37, 63, 65, 200, 300)


def _dkv_rows(bh, L, dh=64):
    """Keys a block (16 a warp) of the bf16 dK/dV kernel's launch: 64 where
    that gives each of the card's 132 SMs a block (two a row tile at dh
    256), else 32, else 16."""
    halves = 2 if dh > 128 else 1
    for rows in (64, 32):
        if bh * halves * -(-L // rows) >= 132:
            return rows
    return 16


def _dkv_bh(rows, L, dh=64):
    """A batch x heads at which the dK/dV kernel takes blocks of ``rows``
    keys (3 for 16, which takes what fills nothing), where some does."""
    halves = 2 if dh > 128 else 1
    bh = 3 if rows == 16 else -(-132 // (halves * -(-L // rows)))
    return bh if _dkv_rows(bh, L, dh) == rows else None


BF16_DKV_PLANS = [(dh, causal, rows, L) for dh in (16, 32, 64, 128, 256)
                  for causal in (False, True) for rows in (64, 32, 16)
                  for L in BF16_DKV_LENGTHS if _dkv_bh(rows, L, dh)]


def _dkv_bias(bh, L):
    """[bh, L] key bias (-1e9 drops a key) whose dropped keys fill the
    second 16-key warp (keys 16-31) and the second 64-key block (keys
    64-127), touch the warp of key 130 and, in every fourth element, the
    first warp (key 3) and the last 37 keys; element 0 keeps no key."""
    bias = torch.zeros(bh, L)
    bias[:, 16:32] = -1e9
    bias[:, 64:128] = -1e9
    bias[:, 130:131] = -1e9
    bias[1::4, 3:4] = -1e9
    bias[1::4, L - 37:] = -1e9
    bias[0] = -1e9
    return bias


def _dkv_paths(L, dh, causal, rows, kept):
    """The paths that the bf16 dK/dV kernel's warps take over the query
    tiles (64 rows, 32 at dh 128) of one head whose keys ``kept`` (a list
    of bools) says are kept, by the kernel's rule: 'dead block' (no key of
    the block kept: nothing loaded), 'dead warp' (no key of the warp kept:
    no product), and for each tile that is not wholly before the warp's
    keys 'edge' (a tile past L), 'diagonal' (causal, some query before
    some key of the warp), else 'interior'; ' dropped' is added where the
    warp drops a key (or has one past L)."""
    bt = 32 if dh > 64 else 64
    paths = set()
    for kb0 in range(0, L, rows):
        if not any(kept[kb0:kb0 + rows]):
            paths.add('dead block')
            continue
        for wk0 in range(kb0, kb0 + rows, 16):
            keys = [k < L and kept[k] for k in range(wk0, wk0 + 16)]
            if not any(keys):
                paths.add('dead warp')
                continue
            tail = '' if all(keys) else ' dropped'
            for q0 in range(kb0 // bt * bt if causal else 0, L, bt):
                if causal and q0 + bt - 1 < wk0:
                    continue
                if q0 + bt > L:
                    paths.add('edge')
                elif causal and q0 < wk0 + 15:
                    paths.add('diagonal' + tail)
                else:
                    paths.add('interior' + tail)
    return paths


@pytest.mark.parametrize('dh,causal,rows,L', BF16_DKV_PLANS)
def test_flash_bf16_dkv_plans_and_tile_paths(dev, dh, causal, rows, L):
    """The bf16 dK/dV kernel in each of its plans (keys a block, chosen by
    the grid's size) at lengths off and on the tile edges, with no bias and
    with one whose dropped keys fill a warp and a block, touch warps and
    drop every key of one element, on the LSE and delta of the plain
    forward: dK and dV within 1e-2 of each one's largest magnitude of the
    plain version (at L 1, where dK is rounding noise around 0, within
    1e-2), the dropped keys' rows exactly 0, and two calls bitwise
    equal."""
    bh = _dkv_bh(rows, L, dh)
    assert attention_ops._bf16_bwd_plan(bh, L, dh) == rows
    q, k, v, do = (_randn(dev, bh, L, dh, seed=s).to(torch.bfloat16)
                   for s in range(4))
    for bias in (None, _dkv_bias(bh, L).to(dev)):
        fwd = (dh ** -0.5, causal, bias, 1)
        o, lse = attention_ops._attention_ref(q, k, v, *fwd)
        args = (q, k, v, do, lse, attention_ops._delta(do, o)) + fwd
        before = kernel_tier.launch_counts()['flash_attention_bf16_bwd_dkv']
        dk, dv = attention_ops._flash_bwd_dkv(*args)
        again = attention_ops._flash_bwd_dkv(*args)
        torch.cuda.synchronize()
        assert kernel_tier.launch_counts()['flash_attention_bf16_bwd_dkv'] \
            == before + 2
        want = attention_ops._bwd_dkv_ref(*args)
        for g, w, a in zip((dk, dv), want, again):
            assert g.dtype == torch.bfloat16
            assert torch.equal(g, a)
            g, w = g.float(), w.float()
            assert torch.isfinite(g).all()
            largest = float(w.abs().max())
            assert _err(g, w) <= 1e-2 * (max(largest, 1.0) if L == 1
                                         else largest)
            if bias is not None:
                assert not g[bias <= -1e8].any()


def test_flash_bf16_dkv_cases_reach_every_plan_and_tile_path():
    """The cases above take every plan that each length allows, and in each
    plan of each head width every path of the dK/dV kernel (by its rule in
    ``_dkv_paths``): the diagonal ones under causal alone, a dead warp
    where a block has more than one. Needs no card."""
    for dh in (16, 32, 64, 128, 256):
        for causal in (False, True):
            for rows in (64, 32, 16):
                reached = set()
                for L in BF16_DKV_LENGTHS:
                    bh = _dkv_bh(rows, L, dh)
                    if bh is None:
                        continue
                    kept = [[True] * L] + \
                        (_dkv_bias(bh, L) > -1e8).tolist()
                    for row in kept:
                        reached |= _dkv_paths(L, dh, causal, rows, row)
                want = {'interior', 'interior dropped', 'edge', 'dead block'}
                if causal:
                    want |= {'diagonal', 'diagonal dropped'}
                if rows > 16:
                    want.add('dead warp')
                assert reached == want, (dh, causal, rows)


def test_flash_bf16_dkv_phase13_shapes_reach_their_paths():
    """chip_smoke.py's phase 13 shapes (the AMP LM step's, causal, and
    BERT's with its key-padding bias) take the dK/dV kernel's widest plan
    and, between them, its interior and diagonal paths, a warp with a
    dropped key, a dead warp and a dead block. The edge path needs L off
    the tiles, which only the cases above reach. Needs no card."""
    import chip_smoke
    reached = set()
    for sh in chip_smoke.flash_shapes(torch, True):
        bh, L = sh['B'] * sh['H'], sh['L']
        assert _dkv_rows(bh, L, sh['dh']) == 64
        rows = [None] if sh['bias'] is None else \
            sorted(set(map(tuple, (sh['bias'] > -1e8).tolist())))
        for row in rows:
            reached |= _dkv_paths(L, sh['dh'], sh['causal'], 64,
                                  [True] * L if row is None else row)
    assert reached == {'interior', 'diagonal', 'interior dropped',
                       'dead warp', 'dead block'}


def _dq_sparse_bias(bh, L):
    """[bh, L] key bias (-1e9 drops a key) that keeps one key of each
    16-key chunk: its last in even elements, its first in odd ones."""
    bias = torch.full((bh, L), -1e9)
    bias[0::2, 15::16] = 0.0
    bias[1::2, 0::16] = 0.0
    return bias


def _dq_chunks(L, dh, causal, rows, kept):
    """The 16-key chunks that the bf16 dQ kernel's warps visit, by its rule,
    in one head whose keys ``kept`` (a list of bools) says are kept, with
    its plan's ``rows`` query rows a block (16 a warp) and key tiles of 64
    (32 at dh 128): a list of (the warp's first row, the chunk's first key,
    path). A block ends its key loop at its last kept key (under causal at
    most its last row) and, when it keeps none, visits nothing: (its first
    row, None, 'dead block'). A warp visits the chunks of those tiles up to
    its last row under causal, else up to L; a chunk that keeps no key is
    'dead chunk' (skipped). The others take 'diagonal' (causal, some key
    after the warp's first row: a compare of key and row) or 'interior',
    plus ' edge' where the tile crosses L or ' dropped' where it drops a
    key (both a select on each key of the tile's chunks)."""
    bt = 32 if dh > 64 else 64
    out = []
    for q0 in range(0, L, rows):
        last_row = min(q0 + rows, L) - 1
        seen = [k for k in range(last_row + 1 if causal else L) if kept[k]]
        if not seen:
            out.append((q0, None, 'dead block'))
            continue
        kend = seen[-1] + 1
        for wq0 in range(q0, min(q0 + rows, L), 16):
            kmax = min(wq0 + 15, L - 1) + 1 if causal else L
            for k0 in range(0, kend, bt):
                tail = ' edge' if k0 + bt > L else \
                    '' if all(kept[k0:k0 + bt]) else ' dropped'
                for c in range(k0, min(kmax, k0 + bt), 16):
                    if not any(kept[c:min(c + 16, L)]):
                        out.append((wq0, c, 'dead chunk'))
                        continue
                    path = 'diagonal' if causal and c + 15 > wq0 \
                        else 'interior'
                    out.append((wq0, c, path + tail))
    return out


def _dq_reach(L, dh, causal, rows, kept):
    """The paths of ``_dq_chunks``, after checking that the (row, key)
    pairs whose p the kernel keeps when it works those chunks by their
    paths' tests (every pair of an interior chunk, the kept keys where a
    select drops keys, key <= row on the diagonal) are exactly those the
    plain version keeps (visible under causal, key kept): no pair is lost
    to a skipped chunk or an interior path, and none masked is kept."""
    chunks = _dq_chunks(L, dh, causal, rows, kept)
    kept = torch.tensor(kept)
    keep = torch.zeros(L, L, dtype=torch.bool)
    for wq0, c, path in chunks:
        if c is None or path == 'dead chunk':
            continue
        rs, ks = slice(wq0, min(wq0 + 16, L)), slice(c, min(c + 16, L))
        tile = torch.ones(rs.stop - rs.start, ks.stop - ks.start,
                          dtype=torch.bool)
        if 'dropped' in path or 'edge' in path:
            tile &= kept[ks][None, :]
        if 'diagonal' in path:
            tile &= torch.arange(ks.start, ks.stop)[None, :] <= \
                torch.arange(rs.start, rs.stop)[:, None]
        keep[rs, ks] = tile
    want = kept[None, :].expand(L, L)
    if causal:
        want = want & torch.ones(L, L, dtype=torch.bool).tril()
    assert torch.equal(keep, want), (L, dh, causal, rows)
    return {path for _, _, path in chunks}


# the dQ kernel takes dK/dV's plan (16 rows a warp; 4, 2 or 1 warps a block)
@pytest.mark.parametrize('dh,causal,rows,L', BF16_DKV_PLANS)
def test_flash_bf16_dq_plans_and_tile_paths(dev, dh, causal, rows, L):
    """The bf16 dQ kernel in each of its plans (query rows a block, chosen
    by the grid's size) at lengths off and on the tile edges, with no bias
    and with one whose dropped keys fill a 64-key tile and a 16-key chunk,
    touch single keys and drop every key of one element, and with one that
    keeps a single key a chunk, on the LSE and delta of the plain forward:
    dQ within 1e-2 of its largest magnitude of
    the plain version (at L 1, where dQ is rounding noise around 0, within
    1e-2), the rows that keep no key exactly 0, two calls bitwise equal,
    and each launch counted."""
    bh = _dkv_bh(rows, L, dh)
    assert attention_ops._bf16_bwd_plan(bh, L, dh) == rows
    q, k, v, do = (_randn(dev, bh, L, dh, seed=s).to(torch.bfloat16)
                   for s in range(4))
    for bias in (None, _dkv_bias(bh, L).to(dev),
                 _dq_sparse_bias(bh, L).to(dev)):
        fwd = (dh ** -0.5, causal, bias, 1)
        o, lse = attention_ops._attention_ref(q, k, v, *fwd)
        args = (q, k, v, do, lse, attention_ops._delta(do, o)) + fwd
        before = kernel_tier.launch_counts()['flash_attention_bf16_bwd_dq']
        dq = attention_ops._flash_bwd_dq(*args)
        again = attention_ops._flash_bwd_dq(*args)
        torch.cuda.synchronize()
        assert kernel_tier.launch_counts()['flash_attention_bf16_bwd_dq'] \
            == before + 2
        want = attention_ops._bwd_dq_ref(*args)
        assert dq.dtype == torch.bfloat16
        assert torch.equal(dq, again)
        got, want = dq.float(), want.float()
        assert torch.isfinite(got).all()
        largest = float(want.abs().max())
        assert _err(got, want) <= 1e-2 * (max(largest, 1.0) if L == 1
                                          else largest)
        _, keep = attention_ops._scores(q, k, dh ** -0.5, causal, bias, 1)
        assert not got[(~keep.any(dim=-1)).expand(bh, L)].any()


def test_flash_bf16_dq_cases_reach_every_plan_and_tile_path():
    """The cases above take every plan that each length allows, and in each
    plan of each head width every path of the dQ kernel (by its rule in
    ``_dq_chunks``, which ``_dq_reach`` first holds to the plain version's
    mask): the diagonal ones under causal alone. Needs no card."""
    for dh in (16, 32, 64, 128, 256):
        for causal in (False, True):
            for rows in (64, 32, 16):
                reached = set()
                for L in BF16_DKV_LENGTHS:
                    bh = _dkv_bh(rows, L, dh)
                    if bh is None:
                        continue
                    kept = [[True] * L] + \
                        (_dkv_bias(bh, L) > -1e8).tolist() + \
                        (_dq_sparse_bias(bh, L) > -1e8).tolist()
                    for row in map(list, sorted(set(map(tuple, kept)))):
                        reached |= _dq_reach(L, dh, causal, rows, row)
                want = {'interior', 'interior dropped', 'interior edge',
                        'dead chunk', 'dead block'}
                if causal:
                    want |= {'diagonal', 'diagonal dropped', 'diagonal edge'}
                assert reached == want, (dh, causal, rows, reached)


def test_flash_bf16_dq_phase13_shapes_reach_their_paths():
    """chip_smoke.py's phase 13 shapes (the AMP LM step's, causal, and
    BERT's with its key-padding bias) take the dQ kernel's widest plan
    and, between them, its interior and diagonal paths, chunks with a
    dropped key, dead chunks and a dead block (the wholly padded element).
    The edge needs L off the chunks, which only the cases above reach.
    Needs no card."""
    import chip_smoke
    reached = set()
    for sh in chip_smoke.flash_shapes(torch, True):
        bh, L = sh['B'] * sh['H'], sh['L']
        assert _dkv_rows(bh, L, sh['dh']) == 64
        rows = [[True] * L] if sh['bias'] is None else \
            map(list, sorted(set(map(tuple, (sh['bias'] > -1e8).tolist()))))
        for row in rows:
            reached |= _dq_reach(L, sh['dh'], sh['causal'], 64, row)
    assert reached == {'interior', 'diagonal', 'interior dropped',
                       'dead chunk', 'dead block'}


def _unscaled_ds_form(q, k, v, do, lse, delta, scale, causal):
    """dQ and dK as the bf16 kernels computed them before they rounded the
    scaled dS: dS rounded to bf16 without the scale, the scale taken once
    at the end (the same bits as the reference only for a power-of-two
    scale)."""
    s, keep = attention_ops._scores(q, k, scale, causal, None, 1)
    p = torch.where(keep, torch.exp(s - lse[:, :, None]),
                    torch.zeros_like(s))
    dp = torch.einsum('bqd,bkd->bqk', do.float(), v.float())
    g = (p * (dp - delta[:, :, None])).to(torch.bfloat16).float()
    dq = torch.einsum('bqk,bkd->bqd', g, k.float()) * scale
    dk = torch.einsum('bqk,bqd->bkd', g, q.float()) * scale
    return dq.to(q.dtype), dk.to(q.dtype)


def _rms_err(g, w):
    g, w = g.float(), w.float()
    return float((g - w).pow(2).mean().sqrt() / w.pow(2).mean().sqrt())


@pytest.mark.parametrize('causal', [False, True], ids=['full', 'causal'])
@pytest.mark.parametrize('dh,scale', [(32, None), (128, None), (64, 0.1),
                                      (256, 0.1)],
                         ids=['dh32', 'dh128', 'dh64-scale0.1',
                              'dh256-scale0.1'])
def test_flash_bf16_bwd_rounds_the_scaled_ds(dev, dh, scale, causal):
    """Where the scale is not a power of two (dh^-0.5 at dh 32 and 128, or
    a caller's 0.1 at dh 64 and 256) the bf16 dQ and dK/dV kernels round
    the scaled dS to bf16, as the reference does: dQ, dK and dV within 1e-2
    of each one's largest magnitude of the plain version, and dQ's and dK's
    root mean square error below that of the form that rounds dS without
    the scale (held to the same plain version)."""
    bh, L = 8, 200
    scale = dh ** -0.5 if scale is None else scale
    q, k, v, do = (_randn(dev, bh, L, dh, seed=s).to(torch.bfloat16)
                   for s in range(4))
    fwd = (scale, causal, None, 1)
    o, lse = attention_ops._attention_ref(q, k, v, *fwd)
    args = (q, k, v, do, lse, attention_ops._delta(do, o))
    dq = attention_ops._flash_bwd_dq(*args, *fwd)
    dk, dv = attention_ops._flash_bwd_dkv(*args, *fwd)
    torch.cuda.synchronize()
    want = (attention_ops._bwd_dq_ref(*args, *fwd),) + \
        attention_ops._bwd_dkv_ref(*args, *fwd)
    for g, w in zip((dq, dk, dv), want):
        assert _err(g.float(), w.float()) <= 1e-2 * float(w.float().abs().max())
    old = _unscaled_ds_form(*args, scale, causal)
    for g, o_, w in zip((dq, dk), old, want):
        assert _rms_err(g, w) < _rms_err(o_, w)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_flash_kernels_take_more_than_65535_rows(dev, dtype):
    """Batch x heads above 65535 (gridDim.y's limit): every row of the
    forward and of both backward kernels against the plain versions."""
    for dh in (16, 256):       # at 256 two blocks a row tile, one a half
        bh, L = 65536 + 3, 8
        q, k, v, do = (_randn(dev, bh, L, dh, seed=s).to(dtype)
                       for s in range(4))
        args = (dh ** -0.5, True, None, 1)
        o, lse = attention_ops._flash_fwd(q, k, v, *args)
        delta = attention_ops._delta(do, o)
        dq = attention_ops._flash_bwd_dq(q, k, v, do, lse, delta, *args)
        dk, dv = attention_ops._flash_bwd_dkv(q, k, v, do, lse, delta, *args)
        torch.cuda.synchronize()
        want = attention_ops._attention_ref(q, k, v, *args) + \
            (attention_ops._bwd_dq_ref(q, k, v, do, lse, delta, *args),) + \
            attention_ops._bwd_dkv_ref(q, k, v, do, lse, delta, *args)
        tol = 1e-4 if dtype == torch.float32 else 1e-2
        for g, w in zip((o, lse, dq, dk, dv), want):
            g, w = g.float(), w.float()
            assert _err(g, w) <= tol * max(1.0, float(w.abs().max()))
            # the last rows too: a grid cut at 65535 would leave them
            # unwritten
            assert _err(g[-3:], w[-3:]) <= \
                tol * max(1.0, float(w.abs().max()))
        del q, k, v, do, o, lse, delta, dq, dk, dv, want
        torch.cuda.empty_cache()


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_flash_kernels_at_head_width_256_are_deterministic(dev, dtype):
    """At head width 256 (two blocks a row tile, each one half of the
    output columns) two calls of the forward, of the dQ kernel and of the
    dK/dV kernel give the same bits, with and without the padding bias, at
    every plan's rows a block (4, 32 and 128 rows x heads at L 200)."""
    L = 200
    for bh in (4, 32, 128):
        q, k, v, do = (_randn(dev, bh, L, 256, seed=s).to(dtype)
                       for s in range(4))
        for b in (None, _padding_bias(dev, bh // 4, L, True)):
            args = (1 / 16, b is None, b, 4)
            first = attention_ops._flash_fwd(q, k, v, *args)
            second = attention_ops._flash_fwd(q, k, v, *args)
            ins = (q, k, v, do, first[1],
                   attention_ops._delta(do, first[0])) + args
            dq = [attention_ops._flash_bwd_dq(*ins) for _ in range(2)]
            dkv = [attention_ops._flash_bwd_dkv(*ins) for _ in range(2)]
            torch.cuda.synchronize()
            for x, y in zip(first + (dq[0],) + dkv[0],
                            second + (dq[1],) + dkv[1]):
                assert torch.equal(x, y)


WIDE_FLASH = ('flash_attention_wide', 'flash_attention_wide_bwd_dq',
              'flash_attention_wide_bwd_dkv')


def _check_wide(q, k, v, do, causal, bias, H):
    """The three wide kernels through the wrappers (padded to the next
    multiple of 128 and sliced back) against the plain versions at the
    true width: f32 O and LSE 1e-4, gradients 1e-4 of their largest
    magnitude; bf16 O and gradients 1e-2 of theirs, LSE 1e-5 (on the rows
    that keep a key); one launch of each a call."""
    dtype, dh = q.dtype, q.shape[-1]
    args = (dh ** -0.5, causal, bias, H)
    before = kernel_tier.launch_counts()
    o, lse = attention_ops._flash_fwd(q, k, v, *args)
    dq, dk, dv = attention_ops._flash_bwd(q, k, v, o, lse, do, *args)
    torch.cuda.synchronize()
    after = kernel_tier.launch_counts()
    assert [after[n] - before[n] for n in WIDE_FLASH] == [1, 1, 1]
    for t in (o, dq, dk, dv):
        assert t.shape == q.shape and t.dtype == dtype and t.is_contiguous()
    o_ref, lse_ref = attention_ops._attention_ref(q, k, v, *args)
    want = attention_ops._flash_bwd_ref(q, k, v, o, lse, do, *args)
    live = torch.ones(q.shape[0], dtype=torch.bool, device=q.device) \
        if bias is None else (bias > -1e8).any(dim=1).repeat_interleave(H)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    assert _err(lse[live], lse_ref[live]) <= \
        (1e-4 if dtype == torch.float32 else 1e-5)
    o_tol = 1e-4 if dtype == torch.float32 else \
        1e-2 * float(o_ref.float().abs().max())
    assert _err(o.float(), o_ref.float()) <= o_tol
    for g, w in zip((dq, dk, dv), want):
        g, w = g.float(), w.float()
        assert torch.isfinite(g).all()
        assert _err(g, w) <= tol * max(1.0, float(w.abs().max()))
    return o, lse, dq, dk, dv


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('dh', [257, 320, 384, 512, 640, 1152, 2048])
def test_flash_wide_kernels_match_their_plain_versions(dev, dh, dtype):
    """Head widths above 256 (padded to 384 or 512: three or four column
    chunks of 128, one forward block a query tile; 640, 1152 and 2048:
    past one group of four chunks, the last group only partly filled at
    640 and 1152, so that further forward blocks take the next groups) at
    L 100 (off every 16-row and 32-key tile), causal and not, with and
    without the key-padding bias (one element wholly padded: its O, dQ, dK
    and dV exactly 0)."""
    B, H, L = 3, 2, 100
    q, k, v, do = (_randn(dev, B * H, L, dh, seed=s).to(dtype)
                   for s in range(4))
    for causal in (True, False):
        for bias in (None, _padding_bias(dev, B, L, True)):
            outs = _check_wide(q, k, v, do, causal, bias, H)
            if bias is not None:
                for t in (outs[0],) + outs[2:]:
                    assert not t[:H].any()


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_flash_wide_kernels_take_more_than_65535_rows(dev, dtype):
    """Batch x heads above 65535 at head width 384: every row, the last
    ones too, against the plain versions."""
    bh, L, dh = 65536 + 3, 8, 384
    q, k, v, do = (_randn(dev, bh, L, dh, seed=s).to(dtype)
                   for s in range(4))
    o, lse, dq, dk, dv = _check_wide(q, k, v, do, True, None, 1)
    delta = attention_ops._delta(do, o)
    args = (dh ** -0.5, True, None, 1)
    want = attention_ops._attention_ref(q, k, v, *args) + \
        (attention_ops._bwd_dq_ref(q, k, v, do, lse, delta, *args),) + \
        attention_ops._bwd_dkv_ref(q, k, v, do, lse, delta, *args)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    for g, w in zip((o, lse, dq, dk, dv), want):
        g, w = g.float(), w.float()
        assert _err(g[-3:], w[-3:]) <= tol * max(1.0, float(w.abs().max()))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_flash_wide_kernels_are_deterministic(dev, dtype):
    """Two calls of each wide kernel give the same bits (one owner per
    output element, a fixed order, no atomics), with and without the
    padding bias, at dh 320, 512 and 1152 (three forward groups)."""
    L = 200
    for dh in (320, 512, 1152):
        q, k, v, do = (_randn(dev, 8, L, dh, seed=s).to(dtype)
                       for s in range(4))
        for b in (None, _padding_bias(dev, 2, L, True)):
            args = (dh ** -0.5, b is None, b, 4)
            first = attention_ops._flash_fwd(q, k, v, *args)
            second = attention_ops._flash_fwd(q, k, v, *args)
            grads = [attention_ops._flash_bwd(q, k, v, first[0], first[1],
                                              do, *args) for _ in range(2)]
            torch.cuda.synchronize()
            for x, y in zip(first + grads[0], second + grads[1]):
                assert torch.equal(x, y)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('dh', [4096, 8192])
def test_flash_wide_forward_takes_any_width(dev, dh, dtype):
    """The wide forward's shared memory is its design's, not the width's:
    at dh 4096 and 8192 (8 and 16 groups of four column chunks) it
    launches, and with the backward holds to the plain versions at a
    small BH and L, causal, with the padding bias (the padded element's
    outputs exactly 0)."""
    B, H, L = 2, 1, 40
    q, k, v, do = (_randn(dev, B * H, L, dh, seed=s).to(dtype)
                   for s in range(4))
    outs = _check_wide(q, k, v, do, True, _padding_bias(dev, B, L, True), H)
    for t in (outs[0],) + outs[2:]:
        assert not t[:H].any()


def test_flash_wide_backward_sums_long_rows(dev):
    """At L 2048 (BH 2, dh 384, causal) dQ sums 64 key tiles and dK/dV 64
    query tiles into each output element: each tile's f32 product joins
    the sum by a rounded FADD (one chain of tensor-core sums truncates),
    so the gradients hold within 1e-4 of their largest magnitude."""
    q, k, v, do = (_randn(dev, 2, 2048, 384, seed=s) for s in range(4))
    _check_wide(q, k, v, do, True, None, 1)


def test_flash_wide_kernels_do_not_spill(dev, tmp_path):
    """ptxas reports no spill in any wide kernel (nvcc with the library's
    own flags into a scratch directory); the forward has one
    instantiation a dtype at every width."""
    import os
    import re
    import subprocess
    from paddle_tpu_torch import native
    out = subprocess.run(
        [native.nvcc_path()] + list(native.NVCC_FLAGS) +
        ['-o', str(tmp_path / 'wide.so'),
         os.path.join(native.CSRC, 'flash_attn_wide.cu')],
        capture_output=True, text=True, check=True)
    spills = re.findall(r'(\d+) bytes spill stores, (\d+) bytes spill loads',
                        out.stdout + out.stderr)
    assert len(spills) == 6       # three kernels, two dtypes
    assert all(a == '0' and b == '0' for a, b in spills), spills


def test_bf16_products_on_the_card_match_the_cpu(dev):
    """The marked product's forward (a bf16 GEMM writing float32) and its
    backward (the float32 cotangent as two bf16 terms) on the card against
    the same arithmetic on the CPU: float32 sums in another order, so the
    bf16-rounded gradients may differ by one bf16 step (2^-8) of an
    element."""
    from paddle_tpu_torch.ops import math_ops
    x, w = _randn(dev, 64, 96), _randn(dev, 96, 80, scale=0.1, seed=1)
    ct = _randn(dev, 64, 80, seed=2)
    res = {}
    for d in (dev, torch.device('cpu')):
        a = [t.detach().to(d).requires_grad_() for t in (x, w)]
        y = math_ops.mul(*a, 'bfloat16')
        y.backward(ct.to(d))
        res[d.type] = [t.cpu() for t in (y.detach(), a[0].grad, a[1].grad)]
    assert res['cuda'][0].dtype == torch.float32
    assert _err(res['cuda'][0], res['cpu'][0]) <= 1e-5 * float(
        res['cpu'][0].abs().max())
    for g, w_ in zip(res['cuda'][1:], res['cpu'][1:]):
        assert _err(g, w_) <= 2 ** -8 * float(w_.abs().max())


def test_amp_training_step_goes_through_the_bf16_kernels(dev):
    """An AMP training step (marked LM, flash on) launches the bf16 flash
    kernels once a layer each, neither the float32 flash kernels nor the
    FFN kernel, and the float32 kernels of the unmarked ops; its loss is
    within 5e-3 of the CPU's (the same arithmetic, sums in another order
    across bf16 roundings)."""
    from paddle_tpu_torch.contrib import mixed_precision as mp
    from paddle_tpu_torch.optimizer import TensorAdam
    cfg = LMConfig(vocab_size=300, seq_len=32, d_model=64, n_head=2,
                   n_layer=2, d_ff=128, dropout=0.0, attn_dropout=0.0)
    params = init_params(cfg, 0, 'cpu')
    g = torch.Generator(device='cpu').manual_seed(0)
    tok = torch.randint(0, 300, (3, 32), generator=g)
    losses = {}
    for d in (dev, torch.device('cpu')):
        m = TransformerLM(cfg, {k: v.to(d) for k, v in params.items()}, 32)
        assert mp.rewrite_model_bf16(m) == 9
        opt = mp.decorate(TensorAdam(m.p, 1e-3, fuse=True))
        kernel_tier.reset_counts()
        losses[d.type] = float(opt.minimize(m.loss(tok.to(d), tok.to(d))))
        counts = kernel_tier.launch_counts()
        n = 2 if d.type == 'cuda' else 0
        assert [counts[k] for k in BF16_FLASH] == [n, n, n]
        for k in ('flash_attention', 'flash_attention_bwd_dq',
                  'flash_attention_bwd_dkv', 'fused_ffn'):
            assert counts[k] == 0, k
        assert counts['fused_ln_residual'] == (5 if n else 0)
        assert counts['fused_adam'] == (1 if n else 0)
    assert abs(losses['cuda'] - losses['cpu']) <= 5e-3 * abs(losses['cpu'])


# speculative decoding on the paged engine, at tests/test_torch_speculative.py's
# tiny shapes (V 64, d 32, 2 heads, 2 layers, max_len 48, blocks of 8)
SPEC_LM = dict(vocab_size=64, seq_len=32, d_model=32, n_head=2, n_layer=2,
               d_ff=64, dropout=0.0, attn_dropout=0.0,
               use_flash_attention=False)
SPEC_WORK = [(4, 9), (7, 14), (12, 6), (16, 11), (40, 8)]
# logits of two tokens this close are a tie (chip_smoke.py's TIE)
TIE = 1e-5


def _spec_cfg(**kw):
    from paddle_tpu_torch.serving import GenerateConfig
    for k, v in dict(model=LMConfig(**SPEC_LM), slots=4, max_len=48,
                     prompt_buckets=[8, 16], paged=True, block_size=8,
                     spec_k=2).items():
        kw.setdefault(k, v)
    return GenerateConfig(**kw)


def _spec_prompts():
    g = torch.Generator(device='cpu').manual_seed(5)
    return [(torch.randint(2, 64, (n,), generator=g).numpy(), m)
            for n, m in SPEC_WORK]


def test_verify_step_on_the_card_matches_the_cpu(dev):
    """The verify step (S * W rows through the gather, LN and FFN kernels)
    on the card against the CPU's plain path on the same weights and
    caches: logits within 1e-4, and each verify row within 1e-4 of the
    card's one-token step at its position; the drafter runs on the card
    and returns [S, K] token ids."""
    cfg = LMConfig(**SPEC_LM)
    params = init_params(cfg, 0, 'cpu')
    g = torch.Generator(device='cpu').manual_seed(1)
    S, W, MB = 4, 3, 6
    kv = [torch.randn(13, 2, 2, 8, 16, generator=g) for _ in range(2)]
    tok = torch.randint(2, 64, (S, W), generator=g)
    pos = torch.tensor([13, 30, 0, 45])[:, None] + torch.arange(W)
    tables = torch.zeros(S, MB, dtype=torch.int64)
    # each live slot's blocks cover its window (slot 1 crosses into its
    # fifth block at position 32)
    tables[0, :2], tables[1, :5], tables[3] = (torch.tensor([3, 5]),
                                               torch.tensor([2, 4, 6, 8, 1]),
                                               torch.arange(7, 13))
    vmask = torch.ones(S, W, dtype=torch.int64)
    vmask[2] = 0
    out = {}
    for d in (dev, torch.device('cpu')):
        m = TransformerLM(cfg, {k: v.to(d) for k, v in params.items()}, 48)
        m.allocate_paged_cache(13, 8)
        m.k_cache.copy_(kv[0])
        m.v_cache.copy_(kv[1])
        kernel_tier.reset_counts()
        a = [t.to(d) for t in (tok, pos, tables, vmask)]
        _, logits = m.verify_step(*a)
        counts = kernel_tier.launch_counts()
        n = 1 if d.type == 'cuda' else 0
        for k in ('embedding_gather', 'fused_ln_residual', 'fused_ffn'):
            assert (counts[k] > 0) == bool(n), k
        # the one-token step at each window row, in order: each rewrites
        # its own row and attends the rows before it
        steps = [m.decode_step(a[0][:, t], a[1][:, t] * a[3][:, t],
                               tables=a[2] * a[3][:, t:t + 1])[1]
                 for t in range(W)]
        drafts = m.draft_steps(a[0][:, 0], a[1][:, 0], a[2], a[3], W - 1)
        out[d.type] = (logits.cpu(), drafts.cpu(),
                       torch.stack(steps, 1).reshape(S * W, -1).cpu())
    live = [s * W + t for s in (0, 1, 3) for t in range(W)]
    assert _err(out['cuda'][0][live], out['cpu'][0][live]) <= 1e-4
    assert _err(out['cuda'][0][live], out['cuda'][2][live]) <= 1e-4
    assert torch.isfinite(out['cuda'][0]).all()
    assert out['cuda'][1].shape == (S, W - 1)
    assert int(out['cuda'][1].min()) >= 0 and int(out['cuda'][1].max()) < 64


def _traced_plain(eng, prompt, n):
    """(tokens, logits of each token's choice) of a plain paged engine's
    generate_once, the logits on the CPU: its bound prefill and step
    signatures (CUDA-graph replays) are wrapped for the call."""
    if not eng._warm:
        eng.warmup()
    rec, bound = [], dict(eng._graphs)

    class traced(object):
        """The bound step, each call's logits recorded; other attributes
        are the step's."""

        def __init__(self, bs):
            self.bs = bs

        def __call__(self, *feeds):
            out = self.bs(*feeds)
            rec.append(out[1][0].to('cpu', copy=True))
            return out

        def __getattr__(self, name):
            return getattr(self.bs, name)

    eng._graphs.update({k: traced(bs) for k, bs in bound.items()
                        if k[0] in ('step', 'prefill', 'prefill_paged')})
    try:
        tokens = eng.generate_once(prompt, max_new_tokens=n)
    finally:
        eng._graphs.update(bound)
    return tokens, rec[-len(tokens):]


def _tie_equal(got, ref, logits):
    """True when ``got`` equals ``ref``, or first differs where the
    reference's two logits lie within TIE."""
    for t, (a, b) in enumerate(zip(got, ref)):
        if a != b:
            return abs(float(logits[t][a] - logits[t][b])) <= TIE
    return len(got) == len(ref)


@pytest.mark.parametrize('draft', ['target', 'one_layer'])
def test_spec_engine_on_the_card_matches_the_plain_engine(dev, draft):
    """Greedy tokens of a speculative engine on the card equal a plain
    paged engine's on the same weights (a token may differ only at a tie:
    the verify step's products run at S * W rows, the plain step's at S);
    the draft with the target's weights accepts at least 95% of its
    proposals."""
    from paddle_tpu_torch.serving import GenerateEngine
    cfg = LMConfig(**SPEC_LM)
    params = init_params(cfg, 0, dev)
    plain = GenerateEngine(_spec_cfg(), params=params, device=dev)
    work = _spec_prompts()
    refs = [_traced_plain(plain, p, n) for p, n in work]
    kw = {'draft_model': LMConfig(**dict(SPEC_LM, n_layer=1))} \
        if draft == 'one_layer' else {}
    spec = GenerateEngine(_spec_cfg(speculative=True, **kw), params=params,
                          device=dev)
    with spec:
        outs = [list(r.result(120)) for r in
                [spec.submit(p, max_new_tokens=n) for p, n in work]]
    for out, (ref, logits) in zip(outs, refs):
        assert _tie_equal(out, ref, logits), (out, ref)
    st = spec.stats()['spec']
    assert st['rounds'] > 0
    if draft == 'target':
        assert st['accept_rate'] >= 0.95, st


def test_spec_engine_on_the_card_drains_both_pools(dev):
    """Greedy requests with short sampled riders (fallback steps, then
    speculation again on stale draft caches, which a resync copies): after
    stop() the draft pool holds no block and the target pool none either
    (the prefix cache is dropped)."""
    from paddle_tpu_torch.serving import GenerateEngine
    cfg = LMConfig(**SPEC_LM)
    eng = GenerateEngine(_spec_cfg(speculative=True),
                         params=init_params(cfg, 0, dev), device=dev)
    prompts = _spec_prompts()
    # (prompt, new tokens, sampled): a rider first and last, every greedy
    # request twice (the second time a prefix hit)
    work = [(prompts[0][0], 3, True)] + [(p, n, False) for p, n in
                                          prompts * 2] + \
        [(prompts[1][0], 3, True)]
    from paddle_tpu_torch import monitor
    before = monitor.counters()
    with eng:
        reqs = [eng.submit(p, max_new_tokens=n,
                           **({'temperature': 0.8, 'sample_seed': i}
                              if smp else {}))
                for i, (p, n, smp) in enumerate(work)]
        outs = [r.result(120) for r in reqs]
        assert eng.stats()['blocks']['in_use'] == \
            eng.stats()['blocks']['prefix_entries']
    assert [len(o) for o in outs] == [n for _, n, _ in work]
    st = eng.stats()
    assert st['spec']['draft_blocks_in_use'] == 0
    assert st['blocks']['in_use'] == 0 and st['active'] == 0
    delta = monitor.counter_delta(before)
    assert delta['spec_fallback_total'] > 0
    assert delta['spec_stale_draft_rounds_total'] > 0


# the decode engine's bound signatures as CUDA graphs (serving/graphs.py)


def _graph_feeds(eng, key, rs):
    """Feeds of signature ``key`` at a live cache state: slot 1 (the
    contiguous cache) or blocks 1.. of every slot's table (paged) at
    position 19; a prefill of 3/4 of its bucket at position 0."""
    c = eng.config
    S, MB = c.slots, eng._max_blocks
    smp = [np.full(n, v, dt) for n, v, dt in ((S, 0.8, 'float32'),
                                              (S, 5, 'int64'),
                                              (S, 0.9, 'float32'),
                                              (S, 0.3, 'float32'))]
    tok = rs.randint(2, c.model.vocab_size, size=S).astype('int64')
    pos = np.full(S, 19, 'int64')
    tab = 1 + np.arange(S * MB).reshape(S, MB) % 7 if MB else None
    if key[0] == 'step':
        return [tok, pos] + smp + ([tab] if MB else [])
    if key[0] in ('prefill', 'prefill_paged'):
        b = key[1]
        prompt = rs.randint(2, c.model.vocab_size, size=(1, b)) \
            .astype('int64')
        one = [a[:1] for a in smp]
        n = np.array([b * 3 // 4])
        if key[0] == 'prefill':
            return [prompt, np.array([1]), n] + one
        return [prompt, np.arange(b), tab[0], n] + one
    W = c.spec_k + 1
    vm = np.ones((S, W), 'int64')
    if key[0] == 'drafter':
        return [tok, pos, tab, vm]
    return [pos[:, None] + np.arange(W), tab, vm]


def _graphed_equals_eager(key, got, want):
    """A replay's outputs against the eager function's: bitwise equal, or
    the logits (the last output) within 1e-6 of the largest logit with
    every differing token a tie (the eager logits of the two tokens within
    TIE). The drafter returns no logits: its drafts must be equal."""
    if all(torch.equal(g, w) for g, w in zip(got, want)):
        return True
    if len(got) < 2:
        return False
    lg, lw = got[-1], want[-1]
    if _err(lg, lw) > 1e-6 * float(lw.abs().max()):
        return False
    tg, tw = got[0], want[0]
    if key == ('verify',):      # drafts, then the verdict of each row
        n = tg.numel() - lw.shape[0]
        if not torch.equal(tg[:n], tw[:n]):
            return False
        tg, tw = tg[n:], tw[n:]
    rows = (tg != tw).nonzero().reshape(-1).tolist()
    return all(abs(float(lw[r, tg[r]] - lw[r, tw[r]])) <= TIE
               for r in rows)


@pytest.mark.parametrize('mode', ['contiguous', 'paged', 'spec'])
def test_engine_graphs_replay_equal_the_eager_path(dev, mode):
    """warmup() captures one graph for each signature; each replay at one
    cache state and one set of feeds equals the signature's eager
    function (the model's own methods) on the same feeds, and adds the
    launches its capture counted to the kernels' counts."""
    from paddle_tpu_torch.serving import GenerateEngine
    cfg = LMConfig(**SPEC_LM)
    kw = {'paged': False} if mode == 'contiguous' else \
        {'speculative': mode == 'spec'}
    eng = GenerateEngine(_spec_cfg(**kw), params=init_params(cfg, 0, dev),
                         device=dev)
    warm = eng.warmup()
    n = 2 + 2 * 2 + (2 if mode == 'spec' else 0)
    assert warm['signatures'] == warm['graphs'] == n
    rs = np.random.RandomState(3)
    for key, bs in sorted(eng.graphs.items(), key=lambda kv: str(kv[0])):
        if key == ('verify',):
            continue                    # after the drafter, below
        feeds = _graph_feeds(eng, key, rs)
        kernel_tier.reset_counts()
        got = [t.clone() for t in bs(*feeds)]
        counts = kernel_tier.launch_counts()
        assert {k: v for k, v in counts.items() if v} == bs.launches
        assert bs.launches['embedding_gather'] >= 1
        want = bs.fn(*[torch.from_numpy(a).to(dev) for a in feeds])
        assert _graphed_equals_eager(key, got, want), key
        if key == ('drafter',):
            vfeeds = _graph_feeds(eng, ('verify',), rs)
            vb = eng.graphs[('verify',)]
            got = [t.clone() for t in vb(*vfeeds)]
            want = vb.fn(*[torch.from_numpy(a).to(dev) for a in vfeeds])
            assert _graphed_equals_eager(('verify',), got, want)
    assert eng.stats()['graphs']['captures_after_warmup'] == 0
    with pytest.raises(RuntimeError, match='CUDA graph'):
        eng.model.allocate_cache(2)


def test_engine_graphs_serve_traffic_without_new_captures(dev):
    """Concurrent greedy and sampled traffic on the graphed contiguous
    engine equals its own generate_once; every signature was captured at
    warmup and replayed since, none captured after."""
    from paddle_tpu_torch.serving import GenerateEngine
    cfg = LMConfig(**SPEC_LM)
    eng = GenerateEngine(_spec_cfg(paged=False),
                         params=init_params(cfg, 0, dev), device=dev)
    eng.warmup()
    work = [(p, m, {'temperature': 0.8, 'sample_seed': i} if i % 2 else {})
            for i, (p, m) in enumerate(_spec_prompts()) if p.size <= 16]
    refs = [eng.generate_once(p, max_new_tokens=m, **kw)
            for p, m, kw in work]
    with eng:
        outs = [list(r.result(120)) for r in
                [eng.submit(p, max_new_tokens=m, **kw)
                 for p, m, kw in work]]
    assert outs == refs
    g = eng.stats()['graphs']
    assert g['captured'] == g['signatures'] == 6
    assert g['replays'] > 0 and g['captures_after_warmup'] == 0


PROGRAM_LM = dict(vocab_size=256, seq_len=64, d_model=128, n_head=4,
                  n_layer=2, d_ff=256, dropout=0.0, attn_dropout=0.0)


def program_step_launches(n_layer):
    """The launches one training step of the flash program makes
    (`build_lm` + ``Adam(fuse=True)``): the gather, the 2L + 1 fused
    LayerNorms forward and backward, the three flash kernels and the FFN
    per layer, the CE forward and backward, one fused Adam."""
    ln = 2 * n_layer + 1
    return dict(dict.fromkeys(kernel_tier.KERNELS, 0), embedding_gather=1,
                fused_ln_residual=ln, fused_ln_residual_bwd=ln,
                flash_attention=n_layer, flash_attention_bwd_dq=n_layer,
                flash_attention_bwd_dkv=n_layer, fused_ffn=n_layer,
                softmax_ce_fwd=1, softmax_ce_bwd=1, fused_adam=1)


def test_program_flash_training_on_the_card_matches_the_cpu(dev):
    """Two steps of the flash program through ``Executor()`` (no place:
    cuda:0) from the CPU run's startup scope: each step launches exactly
    the path's kernels, and the losses lie within 1e-4 relative of the
    CPU's (the repo's f32 limit for an LM step, card against CPU)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.io import scope_from_numpy
    from paddle_tpu_torch.models import transformer

    def build():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            _, _, _, loss = transformer.build_lm(
                transformer.LMConfig(**PROGRAM_LM))
            fluid.optimizer.Adam(1e-3, fuse=True).minimize(loss)
        return main, startup, loss

    rs = np.random.RandomState(0)
    feeds = [{k: rs.randint(0, 256, (3, 64)).astype('int64')
              for k in ('tokens', 'labels')} for _ in range(2)]
    main, startup, loss = build()
    cpu, cpu_scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    cpu.run(startup, scope=cpu_scope)
    init = {n: cpu_scope.get(n).clone() for n in cpu_scope.names()}
    want = [float(cpu.run(main, feed=f, fetch_list=[loss],
                          scope=cpu_scope)[0][0]) for f in feeds]
    main, _, loss = build()
    exe = fluid.Executor()
    assert exe.device == torch.device('cuda', 0)
    scope = scope_from_numpy(init)
    expected = program_step_launches(PROGRAM_LM['n_layer'])
    got = []
    for f in feeds:
        before = kernel_tier.launch_counts()
        got.append(float(exe.run(main, feed=f, fetch_list=[loss],
                                 scope=scope)[0][0]))
        after = kernel_tier.launch_counts()
        assert {k: after[k] - before[k] for k in after} == expected
    assert scope.get('tok_emb.w').device == torch.device('cuda', 0)
    np.testing.assert_allclose(got, want, rtol=1e-4)


AMP_PROGRAM_BERT = dict(vocab_size=256, seq_len=64, d_model=128, n_head=4,
                        n_layer=2, d_ff=256, dropout=0.0, attn_dropout=0.0,
                        max_predictions=8)


def amp_program_step_launches(n_layer, gathers, ces):
    """The launches one training step of an AMP flash program makes
    (``mp.decorate(Adam(fuse=True))``): the gathers, the 2L + 1 fused
    LayerNorms forward and backward, the three bf16 flash kernels a layer,
    the CE forward and backward of each loss, one fused Adam; no FFN
    kernel (the marked FFN stands it down, as the JAX package does) and no
    float32 flash kernel."""
    ln = 2 * n_layer + 1
    return dict(dict.fromkeys(kernel_tier.KERNELS, 0),
                embedding_gather=gathers, fused_ln_residual=ln,
                fused_ln_residual_bwd=ln, flash_attention_bf16=n_layer,
                flash_attention_bf16_bwd_dq=n_layer,
                flash_attention_bf16_bwd_dkv=n_layer, softmax_ce_fwd=ces,
                softmax_ce_bwd=ces, fused_adam=1)


@pytest.mark.parametrize('model', ['lm', 'bert'])
def test_amp_program_training_on_the_card_matches_the_cpu(dev, model):
    """Two steps of the AMP flash LM program and of the AMP BERT program
    (``mp.decorate(Adam(1e-3, fuse=True)).minimize``) through
    ``Executor()`` from the CPU run's startup scope: each step launches
    exactly the AMP path's kernels, the loss lies within 5e-3 relative and
    every parameter's gradient within 2e-2 of its largest magnitude of the
    CPU's (the AMP limits of chip_smoke.py phase 14: the same roundings,
    float32 sums in another order)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.contrib import mixed_precision as mp
    from paddle_tpu_torch.io import scope_from_numpy
    from paddle_tpu_torch.models import transformer

    rs = np.random.RandomState(0)
    if model == 'lm':
        kw = PROGRAM_LM
        feeds = [{k: rs.randint(0, 256, (3, 64)).astype('int64')
                  for k in ('tokens', 'labels')} for _ in range(2)]
        expected = amp_program_step_launches(kw['n_layer'], 1, 1)
    else:
        kw = AMP_PROGRAM_BERT
        feeds = []
        for _ in range(2):
            f = bert.make_pretrain_batch(bert.BertConfig(**kw), 4, rs)
            for row, keep in enumerate((64, 40, 9, 33)):
                f['input_mask'][row, keep:] = 0.0
            feeds.append(f)
        expected = amp_program_step_launches(kw['n_layer'], 2, 2)

    def build():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            if model == 'lm':
                loss = transformer.build_lm(transformer.LMConfig(**kw))[3]
            else:
                loss = bert.build_bert_pretrain(bert.BertConfig(**kw))[0]
            opt = mp.decorate(fluid.optimizer.Adam(1e-3, fuse=True))
            params_grads = opt.minimize(loss)[1]
        grads = [g.name for _, g in params_grads]
        return main, startup, [loss.name] + grads

    main, startup, fetch = build()
    cpu, cpu_scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    cpu.run(startup, scope=cpu_scope)
    init = {n: cpu_scope.get(n).clone() for n in cpu_scope.names()}
    want = [cpu.run(main, feed=f, fetch_list=fetch, scope=cpu_scope)
            for f in feeds]
    main, _, fetch = build()
    exe = fluid.Executor()
    scope = scope_from_numpy(init)
    for f, w in zip(feeds, want):
        before = kernel_tier.launch_counts()
        got = exe.run(main, feed=f, fetch_list=fetch, scope=scope)
        after = kernel_tier.launch_counts()
        assert {k: after[k] - before[k] for k in after} == expected
        assert np.isfinite(got[0]).all()
        assert abs(got[0][0] - w[0][0]) <= 5e-3 * abs(w[0][0])
        for name, g, gw in zip(fetch[1:], got[1:], w[1:]):
            assert np.abs(g - gw).max() <= 2e-2 * max(np.abs(gw).max(),
                                                      1e-30), name


def _bound_lm(dropout):
    """(main, startup, loss) of the flash program at PROGRAM_LM's width with
    ``dropout``, seeded, under ``Adam(1e-3, fuse=True)``."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import transformer
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        _, _, _, loss = transformer.build_lm(transformer.LMConfig(
            **dict(PROGRAM_LM, dropout=dropout)))
        fluid.optimizer.Adam(1e-3, fuse=True).minimize(loss)
    return main, startup, loss


def _bound_lm_feeds(n):
    rs = np.random.RandomState(1)
    return [{k: rs.randint(0, 256, (3, 64)).astype('int64')
             for k in ('tokens', 'labels')} for _ in range(n)]


def _hold_bound_to_eager(got, want, got_scope, want_scope, names,
                         lr=1e-3):
    """Losses within 1e-4 relative, every parameter within 1e-3 of its
    largest magnitude (chip_smoke.py's limits for a bound step, the f32
    LM step's): the K slice of each ``*.attn.qkv.b``, whose true gradient
    is 0 and whose Adam steps of lr follow rounding noise, within 10 x
    lr."""
    np.testing.assert_allclose(got, want, rtol=1e-4)
    d = PROGRAM_LM['d_model']
    for n in names:
        have, ref = got_scope.get(n), want_scope.get(n)
        if n.endswith('.attn.qkv.b'):
            assert float((have[d:2 * d] - ref[d:2 * d]).abs().max()) <= \
                10 * lr, n
            have = torch.cat([have[:d], have[2 * d:]])
            ref = torch.cat([ref[:d], ref[2 * d:]])
        assert float((have - ref).abs().max()) <= \
            1e-3 * float(ref.abs().max().clamp_min(1e-30)), n


def test_bound_program_step_replays_the_eager_step(dev):
    """``Executor().bind`` of the flash program with dropout 0.1: the bind
    step is eager and captures the next one; each later call replays that
    graph, launches exactly one step's kernels and follows the eager
    ``run()`` trajectory of the same seed and run counters; a feed of
    another shape raises and nothing is captured after ``bind``."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.io import scope_from_numpy
    feeds = _bound_lm_feeds(5)
    main, startup, loss = _bound_lm(0.1)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    init = {n: scope.get(n).clone() for n in scope.names()}
    want = [float(exe.run(main, feed=f, fetch_list=[loss],
                          scope=scope)[0][0]) for f in feeds]
    main, _, loss = _bound_lm(0.1)
    exe, bscope = fluid.Executor(), scope_from_numpy(init)
    bp = exe.bind(main, feeds[0], fetch_list=[loss], scope=bscope)
    assert bp.captures == 1 and bp.replays == 0
    expected = program_step_launches(PROGRAM_LM['n_layer'])
    assert bp.launches == {k: v for k, v in expected.items() if v}
    got = [float(bp.first_out[0][0])]
    for f in feeds[1:]:
        before = kernel_tier.launch_counts()
        got.append(float(bp(f)[0][0]))
        after = kernel_tier.launch_counts()
        assert {k: after[k] - before[k] for k in after} == expected
    assert bp.replays == len(feeds) - 1 and bp.captures == 1
    _hold_bound_to_eager(got, want, bscope, scope,
                         [p.name for p in main.all_parameters()])
    with pytest.raises(ValueError, match='bound'):
        bp(dict(feeds[0], tokens=feeds[0]['tokens'][:2]))


def test_binds_capture_while_other_threads_scrape_and_dispatch(dev):
    """Captures are thread-local: while this thread binds programs (an
    eager step, then a CUDA-graph capture) four times, one thread scrapes
    /metrics in a loop (goodput's pre-snapshot flush on the monitor's
    thread) and another runs a program eagerly (each run records CUDA
    events, allocates and reads its loss on the host). Every capture
    holds, and each bound call follows the eager run of the same feeds."""
    import threading
    import urllib.request
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.io import scope_from_numpy
    feeds = _bound_lm_feeds(2)
    main_d, startup_d, loss_d = _bound_lm(0.0)
    exe_d, scope_d = fluid.Executor(), fluid.Scope()
    exe_d.run(startup_d, scope=scope_d)
    exe_d.run(main_d, feed=feeds[0], fetch_list=[loss_d], scope=scope_d)
    stop, errors, done = threading.Event(), [], {'scrapes': 0, 'runs': 0}
    server = monitor.serve_metrics(port=0)

    def scrape():
        url = 'http://127.0.0.1:%d/metrics' % server.port
        while not stop.is_set():
            try:
                urllib.request.urlopen(url, timeout=30).read()
                done['scrapes'] += 1
            except Exception as e:      # noqa: BLE001 — reported below
                errors.append(e)
                return

    def dispatch():
        while not stop.is_set():
            try:
                exe_d.run(main_d, feed=feeds[1], fetch_list=[loss_d],
                          scope=scope_d)
                done['runs'] += 1
            except Exception as e:      # noqa: BLE001 — reported below
                errors.append(e)
                return

    threads = [threading.Thread(target=f) for f in (scrape, dispatch)]
    for t in threads:
        t.start()
    try:
        for _ in range(4):
            main, startup, loss = _bound_lm(0.0)
            exe, scope = fluid.Executor(), fluid.Scope()
            exe.run(startup, scope=scope)
            init = {n: scope.get(n).clone() for n in scope.names()}
            want = [float(exe.run(main, feed=f, fetch_list=[loss],
                                  scope=scope)[0][0]) for f in feeds]
            main, _, loss = _bound_lm(0.0)
            bscope = scope_from_numpy(init)
            bp = fluid.Executor().bind(main, feeds[0], fetch_list=[loss],
                                       scope=bscope)
            got = [float(bp.first_out[0][0]), float(bp(feeds[1])[0][0])]
            assert bp.captures == 1 and bp.replays == 1
            _hold_bound_to_eager(got, want, bscope, scope,
                                 [p.name for p in main.all_parameters()])
    finally:
        stop.set()
        for t in threads:
            t.join(120)
        server.close()
    assert not errors, errors
    assert done['scrapes'] > 0 and done['runs'] > 0, done


def test_program_analytics_leave_the_peak_statistics_alone(dev):
    """analysis.py never resets the card's peak statistics: a plan whose
    first step sets no new peak records no ``peak_bytes`` and leaves
    ``max_memory_allocated`` as it was; after the caller resets them, a
    new plan's first step records the new peak less its base."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import analysis
    feed = _bound_lm_feeds(1)[0]
    main, startup, loss = _bound_lm(0.0)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    big = torch.empty(4 << 30, dtype=torch.uint8, device=dev)
    del big
    high = torch.cuda.max_memory_allocated(dev)
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert torch.cuda.max_memory_allocated(dev) == high
    assert analysis.lookup(main, kind='run').peak_bytes is None
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    main, _, loss = _bound_lm(0.0)
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    peak = analysis.lookup(main, kind='run').peak_bytes
    # the plan's base is taken in the run, after its feeds were staged
    assert 0 < peak <= torch.cuda.max_memory_allocated(dev) - base


def test_bound_dropout_masks_equal_run_masks_on_the_card(dev):
    """Dropout 0.1 on a fed [64, 1024] tensor with its mask fetched: each
    bound call (a replay, after the bind step) draws bitwise the mask that
    ``run()`` draws at the same run index, and two consecutive calls draw
    different masks."""
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
    assert bp.replays == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert not np.array_equal(got[2], got[3])
    assert 0.05 < 1 - got[3].mean() < 0.15


def test_run_fused_on_the_card_equals_k_run_calls(dev):
    """``run_fused`` over K batches stacked on the card (``steps`` 2K, so
    it cycles them) against 2K ``run()`` calls: the same limits as the
    bound step, and one replay's kernels a step after the first."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.io import scope_from_numpy
    feeds = _bound_lm_feeds(3)
    main, startup, loss = _bound_lm(0.1)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    init = {n: scope.get(n).clone() for n in scope.names()}
    want = [float(exe.run(main, feed=feeds[i % 3], fetch_list=[loss],
                          scope=scope)[0][0]) for i in range(6)]
    main, _, loss = _bound_lm(0.1)
    exe, fscope = fluid.Executor(), scope_from_numpy(init)
    stacked = {k: torch.from_numpy(np.stack([f[k] for f in feeds])).to(dev)
               for k in feeds[0]}
    first = exe.run_fused(main, stacked, fetch_list=[loss], scope=fscope,
                          steps=3)
    before = kernel_tier.launch_counts()
    last = exe.run_fused(main, stacked, fetch_list=[loss], scope=fscope,
                         steps=3)
    after = kernel_tier.launch_counts()
    expected = program_step_launches(PROGRAM_LM['n_layer'])
    assert {k: after[k] - before[k] for k in after} == \
        {k: 3 * v for k, v in expected.items()}
    _hold_bound_to_eager([float(first[0][0]), float(last[0][0])],
                         [want[2], want[5]], fscope, scope,
                         [p.name for p in main.all_parameters()])


# ---------------------------------------------------------------------------
# the image ops and the predictor (port PR 17): library calls on the card
# (cuDNN, ATen), held to the CPU with cuDNN's TF32 flag at torch's default


@pytest.fixture
def tf32_default(dev):
    """cuDNN's TF32 flag at torch's default (True) for the test, and back
    afterwards: the conv lowering must hold float32 by itself."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    yield dev
    assert torch.backends.cudnn.allow_tf32 is True
    torch.backends.cudnn.allow_tf32 = prev


def _rel_err(got, want):
    return float((got.cpu() - want).abs().max() / want.abs().max())


# (N, C, H, W, O, k, stride, padding, dilation, groups): ResNet-50's stem,
# a 3 x 3 stage conv, a 1 x 1 stride-2 shortcut, dilation, groups and a
# depthwise conv
CARD_CONV_CASES = [(2, 3, 33, 31, 16, 7, 2, 3, 1, 1),
                   (2, 256, 14, 14, 256, 3, 1, 1, 1, 1),
                   (2, 512, 14, 14, 1024, 1, 2, 0, 1, 1),
                   (2, 16, 17, 15, 24, 3, 1, 2, 2, 1),
                   (2, 32, 9, 9, 64, 3, 2, 1, 1, 4),
                   (2, 32, 9, 9, 32, 3, 1, 1, 1, 32)]


@pytest.mark.parametrize('case', CARD_CONV_CASES,
                         ids=lambda c: 'C%d_O%d_k%d_s%d_d%d_g%d' % (
                             c[1], c[4], c[5], c[6], c[8], c[9]))
def test_conv2d_on_the_card_matches_the_cpu_without_tf32(tf32_default,
                                                         case):
    """The forward and both gradients within 1e-5 of each one's largest
    magnitude of the CPU's (TF32 would be about 1e-3 off)."""
    from paddle_tpu_torch.ops import conv_ops
    n, c, h, w, o, k, s, p, d, g = case
    x = _randn('cpu', n, c, h, w, seed=1)
    f = _randn('cpu', o, c // g, k, k, scale=(2.0 / (c // g * k * k)) ** 0.5,
               seed=2)
    dy = _randn('cpu', n, o, (h + 2 * p - d * (k - 1) - 1) // s + 1,
                (w + 2 * p - d * (k - 1) - 1) // s + 1, seed=3)
    outs = []
    for on in ('cpu', tf32_default):
        xi = x.to(on).detach().requires_grad_()
        fi = f.to(on).detach().requires_grad_()
        y = conv_ops.conv2d(xi, fi, (s, s), (p, p), (d, d), g)
        y.backward(dy.to(on))
        outs.append((y.detach(), xi.grad, fi.grad))
    for got, want in zip(outs[1], outs[0]):
        assert _rel_err(got, want) <= 1e-5


@pytest.mark.parametrize('ptype,excl,ceil,pad,glob', [
    ('max', True, False, 1, False), ('max', True, True, 1, False),
    ('avg', True, True, 1, False), ('avg', False, True, 0, False),
    ('avg', True, False, 1, False), ('avg', True, False, 0, True)])
def test_pool2d_on_the_card_matches_the_cpu(dev, ptype, excl, ceil, pad,
                                            glob):
    from paddle_tpu_torch.ops import conv_ops
    x = _randn('cpu', 4, 64, 56, 55, seed=4)
    args = ((3, 3), (2, 2), (pad, pad), ptype, excl, False, glob, ceil)
    want = conv_ops.pool2d(x, *args)
    got = conv_ops.pool2d(x.to(dev), *args)
    assert got.shape == want.shape
    assert _rel_err(got, want) <= 1e-5


@pytest.mark.parametrize('is_test', [False, True], ids=['train', 'test'])
def test_batch_norm_on_the_card_matches_the_cpu(dev, is_test):
    """A one-op batch_norm program on the card and on the CPU: every
    output within 1e-5 of its largest magnitude, the moving statistics
    written back to the scope."""
    import paddle_tpu_torch as fluid
    c = 64
    x = _randn('cpu', 8, c, 14, 14, seed=5).numpy()
    x[:, 1] = 1e3 + 2.0 ** -7 * np.round(4 * x[:, 1])
    state = {'sc': 1 + 0.1 * np.random.RandomState(6).randn(c),
             'b': 0.1 * np.random.RandomState(7).randn(c),
             'm': np.random.RandomState(8).randn(c),
             'v': 0.5 + np.random.RandomState(9).rand(c)}
    outs = ['y', 'm', 'v', 'sm', 'sv']
    got = {}
    for place in (fluid.CPUPlace(), None):
        main = fluid.Program()
        block = main.global_block()
        block.create_var(name='x', shape=x.shape, dtype='float32')
        for n in state:
            block.create_var(name=n, shape=(c,), dtype='float32',
                             persistable=True)
        for n in ('y', 'sm', 'sv'):
            block.create_var(name=n, dtype='float32')
        block.append_op(
            type='batch_norm',
            inputs={'X': ['x'], 'Scale': ['sc'], 'Bias': ['b'],
                    'Mean': ['m'], 'Variance': ['v']},
            outputs={'Y': ['y'], 'MeanOut': ['m'], 'VarianceOut': ['v'],
                     'SavedMean': ['sm'], 'SavedVariance': ['sv']},
            attrs={'momentum': 0.9, 'epsilon': 1e-5, 'is_test': is_test,
                   'data_layout': 'NCHW', 'use_global_stats': False})
        scope = fluid.Scope()
        for n, a in state.items():
            scope.set(n, a.astype('float32'))
        res = fluid.Executor(place).run(main, feed={'x': x},
                                        fetch_list=outs, scope=scope)
        got[place is None] = [torch.from_numpy(r) for r in res] + [
            scope.get('m').cpu()]
    for card, cpu in zip(got[True], got[False]):
        assert _rel_err(card, cpu) <= 1e-5


def test_resnet_predictor_on_the_card_matches_the_cpu(tf32_default,
                                                      tmp_path):
    """The cifar10 ResNet of depth 8 saved once: the card's predictor
    within 1e-5 of the CPU's (the softmax's input, fetched by name), no
    hand-written launch, the parameters uploaded once, and ``run_fused`` of
    its program (a captured graph) equal to its calls."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import resnet
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        _, _, pred_v, _, _ = resnet.build('cifar10', depth=8)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup, scope=scope)
        rs = np.random.RandomState(3)
        for n in scope.names():
            if n.endswith('.mean'):
                scope.set(n, rs.randn(*scope.get(n).shape).astype('float32'))
        fluid.io.save_inference_model(str(tmp_path), ['img'], [pred_v], exe,
                                      main_program=main)
    card = fluid.create_predictor(str(tmp_path))
    cpu = fluid.create_predictor(fluid.PredictorConfig(
        str(tmp_path), place=fluid.CPUPlace()))
    logits = [op for op in card.program.global_block().ops
              if op.type == 'softmax'][-1].input('X')[0]
    feeds = [{'img': rs.randn(4, 3, 32, 32).astype('float32')}
             for _ in range(2)]
    before = kernel_tier.launch_counts()
    got = [card.executor.run(card.program, feed=f, fetch_list=[logits],
                             scope=card.scope)[0] for f in feeds]
    assert kernel_tier.launch_counts() == before
    held = {n: card.scope.get(n) for n in card.scope.names()}
    assert all(t.is_cuda for t in held.values())
    for f, g in zip(feeds, got):
        w = cpu.executor.run(cpu.program, feed=f, fetch_list=[logits],
                             scope=cpu.scope)[0]
        assert _rel_err(torch.from_numpy(g), torch.from_numpy(w)) <= 1e-5
    runs = [card.run(f)[0] for f in feeds]
    with fluid.scope_guard(card.scope):
        fused = card.executor.run_fused(
            card.program, {'img': np.stack([f['img'] for f in feeds])},
            fetch_list=card.fetch_vars)
    assert _rel_err(torch.from_numpy(fused[0]),
                    torch.from_numpy(runs[1])) <= 1e-5
    assert all(card.scope.get(n) is t for n, t in held.items())


def _kept_conv_bn_program(fluid, c, o):
    """A program of a marked, kept conv2d (3 x 3, padding 1) and a
    batch_norm of its output: (program, output names)."""
    from paddle_tpu_torch.core import amp
    main = fluid.Program()
    block = main.global_block()
    block.create_var(name='x', shape=(-1, c, -1, -1), dtype='float32')
    for n, shape in (('w', (o, c, 3, 3)), ('sc', (o,)), ('b', (o,)),
                     ('m', (o,)), ('v', (o,))):
        block.create_var(name=n, shape=shape, dtype='float32',
                         persistable=True)
    for n in ('y', 'z', 'sm', 'sv'):
        block.create_var(name=n, dtype='float32')
    block.append_op(type='conv2d', inputs={'Input': ['x'], 'Filter': ['w']},
                    outputs={'Output': ['y']},
                    attrs={'strides': [1, 1], 'paddings': [1, 1],
                           'dilations': [1, 1], 'groups': 1,
                           amp.AMP_ATTR: 'bfloat16', amp.AMP_KEEP_ATTR: True})
    block.append_op(type='batch_norm',
                    inputs={'X': ['y'], 'Scale': ['sc'], 'Bias': ['b'],
                            'Mean': ['m'], 'Variance': ['v']},
                    outputs={'Y': ['z'], 'MeanOut': ['m'],
                             'VarianceOut': ['v'], 'SavedMean': ['sm'],
                             'SavedVariance': ['sv']},
                    attrs={'momentum': 0.9, 'epsilon': 1e-5,
                           'is_test': False, 'data_layout': 'NCHW',
                           'use_global_stats': False})
    return main, ['y', 'z', 'sm', 'sv', 'm', 'v']


def test_kept_conv_and_batch_norm_on_the_card_match_the_cpu(tf32_default):
    """Keep-bf16 AMP on the card: the program of a marked, kept conv2d and a
    batch norm of its bf16 output on the card and on the CPU Executor. The
    convolution and ``Y`` come back bf16 (the TF32 flag left at its
    default: a bf16 convolution does not take the float32 path), within
    1e-2 of their largest magnitudes of the CPU's (bf16's step: the two
    libraries sum in other orders, so an element may round one bf16 step
    apart). The statistics are float32 of those bf16 values: on each side
    the saved mean and variance and the moving ones (momentum 0.9 from 0
    and 1) within 1e-5 of the float64 statistics of that side's own
    convolution output (relative to the largest magnitude). Then the kept
    convolution's gradients by both operands through autograd, within
    1e-2."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import conv_ops
    c, o = 64, 128
    x = _randn('cpu', 8, c, 28, 28, seed=11)
    state = {'w': _randn('cpu', o, c, 3, 3, scale=(2.0 / (9 * c)) ** 0.5,
                         seed=12),
             'sc': 1 + _randn('cpu', o, scale=0.1, seed=13),
             'b': _randn('cpu', o, scale=0.1, seed=14),
             'm': torch.zeros(o), 'v': torch.ones(o)}
    main, names = _kept_conv_bn_program(fluid, c, o)
    got = {}
    for place in (fluid.CPUPlace(), None):
        scope = fluid.Scope()
        for n, t in state.items():
            scope.set(n, t.clone())
        res = fluid.Executor(place).run(main, feed={'x': x.numpy()},
                                        fetch_list=names, scope=scope,
                                        return_numpy=False)
        got[place is None] = res
        assert res[0].dtype == res[1].dtype == torch.bfloat16
        assert all(r.dtype == torch.float32 for r in res[2:])
        assert torch.backends.cudnn.allow_tf32 is True
    for i in (0, 1):
        assert _rel_err(got[True][i].float(), got[False][i].float()) <= \
            1e-2, names[i]
    for res in got.values():
        y = res[0].cpu().double()
        mean = y.mean(dim=(0, 2, 3))
        var = y.var(dim=(0, 2, 3), unbiased=False)
        want = {'sm': mean, 'sv': 1.0 / torch.sqrt(var + 1e-5),
                'm': 0.1 * mean, 'v': 0.9 + 0.1 * var}
        for n, w in want.items():
            assert _rel_err(res[names.index(n)].double(), w) <= 1e-5, n
    ct = _randn('cpu', 8, o, 28, 28, seed=15)
    grads = []
    for on in ('cpu', tf32_default):
        xi = x.to(on).detach().requires_grad_()
        fi = state['w'].to(on).detach().requires_grad_()
        y = conv_ops.conv2d(xi, fi, (1, 1), (1, 1), (1, 1), 1,
                            policy='bfloat16', keep=True)
        (y.float() * ct.to(on)).sum().backward()
        grads.append((xi.grad, fi.grad))
    for g, w in zip(grads[1], grads[0]):
        assert _rel_err(g, w) <= 1e-2


def _keep_bf16_resnet8():
    """(main, loss, init, feeds) of the cifar10 ResNet of depth 8 under
    ``decorate(Momentum, keep_bf16_activations=True)``, four batches of 8
    images."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.contrib import mixed_precision as mp
    from paddle_tpu_torch.models import resnet
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 4
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        _, _, _, loss, _ = resnet.build('cifar10', depth=8)
        mp.decorate(fluid.optimizer.Momentum(0.05, 0.9),
                    keep_bf16_activations=True).minimize(loss)
    s0 = fluid.Scope()
    fluid.Executor().run(startup, scope=s0)
    init = {n: s0.get(n).cpu() for n in s0.names()}
    rs = np.random.RandomState(5)
    feeds = [{'img': rs.randn(8, 3, 32, 32).astype('float32'),
              'label': rs.randint(0, 10, (8, 1)).astype('int64')}
             for _ in range(4)]
    return main, loss, init, feeds


def _bound_and_run_calls(dev, main, loss, init, feeds):
    """(bound program, its scope, its losses, the ``run()`` scope, its
    losses): ``bind`` and three bound calls against four ``run()`` calls
    of another Executor from the same state."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.io import scope_from_numpy
    ref = scope_from_numpy(init, device=dev)
    exe = fluid.Executor()
    want = [exe.run(main, feed=f, fetch_list=[loss], scope=ref)[0]
            for f in feeds]
    bound = scope_from_numpy(init, device=dev)
    bp = fluid.Executor().bind(main, feeds[0], fetch_list=[loss],
                               scope=bound)
    got = [bp.first_out[0]] + [bp(f)[0] for f in feeds[1:]]
    return bp, bound, np.concatenate(got), ref, np.concatenate(want)


def test_bound_momentum_batch_norm_steps_equal_run_calls(dev):
    """The cifar10 ResNet of depth 8 under ``decorate(Momentum,
    keep_bf16_activations=True)`` at B 8: ``bind`` and three bound calls
    (a captured graph) against four ``run()`` calls from the same state on
    another Executor, under cuDNN's deterministic algorithms: the losses,
    every parameter, velocity and moving statistic bitwise equal."""
    main, loss, init, feeds = _keep_bf16_resnet8()
    with torch.backends.cudnn.flags(enabled=True, deterministic=True):
        bp, bound, got, ref, want = _bound_and_run_calls(dev, main, loss,
                                                         init, feeds)
    assert bp.captures == 1 and bp.replays == 3
    np.testing.assert_array_equal(got, want)
    stats = [n for n in init if n.endswith(('.mean', '.variance'))]
    assert len(stats) == 18
    for n in init:
        assert torch.equal(bound.get(n), ref.get(n)), n
    assert not all(torch.equal(ref.get(n).cpu(), init[n]) for n in stats)


def test_bound_momentum_batch_norm_steps_hold_run_calls_by_default(dev):
    """The same four steps under the default flags, cuDNN free to pick a
    nondeterministic backward: the bound losses within 5e-3 relative of
    the ``run()`` losses, every parameter, velocity and moving statistic
    within 2e-2 of its largest magnitude over the model (`PERF.md` §2's
    AMP limits)."""
    main, loss, init, feeds = _keep_bf16_resnet8()
    assert not torch.backends.cudnn.deterministic
    bp, bound, got, ref, want = _bound_and_run_calls(dev, main, loss, init,
                                                     feeds)
    assert bp.captures == 1 and bp.replays == 3
    np.testing.assert_allclose(got, want, rtol=5e-3)
    params = {p.name for p in main.all_parameters()}
    for group in (params, set(init) - params):
        floats = [n for n in group if init[n].is_floating_point()]
        top = max(float(ref.get(n).abs().max()) for n in floats)
        for n in floats:
            assert float((bound.get(n) - ref.get(n)).abs().max()) <= \
                2e-2 * top, n


# ---------------------------------------------------------------------------
# ragged (LoD) sequences: the sequence ops, the recurrences and
# the bound plans of a LoD on the card, held to the CPU Executor


_RAGGED = [[0, 3, 3, 4, 8, 10]]     # lengths 3, 0, 1, 4, 2


def _ragged_op_run(place, op_type, inputs, outputs, attrs, weights):
    """Outputs and input gradients of a one-op program (each float input
    persistable, its LoD in the scope) whose loss is the sum of each output
    times ``weights[output]``."""
    import paddle_tpu_torch as fluid
    main = fluid.Program()
    block = main.global_block()
    scope = fluid.Scope()
    for slot, items in inputs.items():
        for name, arr, lod in items:
            block.create_var(name=name, shape=arr.shape, dtype=arr.dtype,
                             persistable=True, stop_gradient=False)
            scope.set(name, arr.copy())
            if lod:
                scope._lods[name] = tuple(tuple(l) for l in lod)
    for n in outputs.values():
        block.create_var(name=n[0], dtype='float32')
    block.append_op(type=op_type,
                    inputs={k: [i[0] for i in v] for k, v in inputs.items()},
                    outputs=outputs, attrs=attrs)
    terms = []
    for n, w in weights.items():
        block.create_var(name=n + '@w', shape=w.shape, dtype='float32',
                         persistable=True)
        scope.set(n + '@w', w)
        for op, ins, out, at in (
                ('elementwise_mul', {'X': [n], 'Y': [n + '@w']}, n + '@wx',
                 {'axis': -1}),
                ('reduce_sum', {'X': [n + '@wx']}, n + '@s',
                 {'dim': [0], 'keep_dim': False, 'reduce_all': True})):
            block.create_var(name=out, dtype='float32')
            block.append_op(type=op, inputs=ins, outputs={'Out': [out]},
                            attrs=at)
        terms.append(n + '@s')
    loss = block.create_var(name='loss', dtype='float32')
    block.append_op(type='sum', inputs={'X': terms},
                    outputs={'Out': [loss]}, attrs={})
    wrt = [i[0] for v in inputs.values() for i in v]
    grads = [g.name for _, g in fluid.append_backward(loss,
                                                      parameter_list=wrt)]
    names = [n[0] for n in outputs.values()] + grads
    return dict(zip(names, fluid.Executor(place).run(
        main, fetch_list=names, scope=scope)))


def _ragged_cases():
    rs = np.random.RandomState(19)
    f = lambda *s: rs.randn(*s).astype('float32')
    x = f(10, 6)
    ties = np.maximum(np.round(rs.randn(10, 6)), 0).astype('float32')
    sig = {'gate_activation': 'sigmoid', 'cell_activation': 'tanh',
           'candidate_activation': 'tanh'}
    c = {}
    for pool in ('SUM', 'AVERAGE', 'SQRT', 'MAX', 'LAST', 'FIRST'):
        c['pool_' + pool] = ('sequence_pool', {'X': [('x', x, _RAGGED)]},
                             {'Out': ['out']}, {'pooltype': pool})
    c['pool_MAX_ties'] = ('sequence_pool', {'X': [('x', ties, _RAGGED)]},
                          {'Out': ['out']}, {'pooltype': 'MAX'})
    c['softmax'] = ('sequence_softmax', {'X': [('x', f(10, 1), _RAGGED)]},
                    {'Out': ['out']}, {})
    c['pad'] = ('sequence_pad', {'X': [('x', x, _RAGGED)],
                                 'PadValue': [('pv', f(1), None)]},
                {'Out': ['out']}, {'padded_length': 6})
    c['reverse'] = ('sequence_reverse', {'X': [('x', x, _RAGGED)]},
                    {'Y': ['out']}, {})
    c['conv'] = ('sequence_conv', {'X': [('x', x, _RAGGED)],
                                   'Filter': [('w', f(18, 5), None)]},
                 {'Out': ['out']},
                 {'contextLength': 3, 'contextStart': -1,
                  'contextStride': 1})
    c['lstm'] = ('lstm', {'Input': [('x', f(10, 16), _RAGGED)],
                          'Weight': [('w', f(4, 16) * 0.5, None)],
                          'Bias': [('b', f(1, 28) * 0.5, None)]},
                 {'Hidden': ['h'], 'Cell': ['c']},
                 dict(sig, use_peepholes=True, is_reverse=True))
    c['gru'] = ('gru', {'Input': [('x', f(10, 12), _RAGGED)],
                        'Weight': [('w', f(4, 12) * 0.5, None)],
                        'Bias': [('b', f(1, 12) * 0.5, None)]},
                {'Hidden': ['h']},
                {'gate_activation': 'sigmoid', 'activation': 'tanh',
                 'origin_mode': True, 'is_reverse': False})
    return c


RAGGED_CASES = _ragged_cases()


@pytest.mark.parametrize('key', sorted(RAGGED_CASES))
def test_ragged_op_on_the_card_matches_the_cpu(dev, key):
    """Each sequence op and recurrence (an empty sequence, one of length
    1, MAX ties) on the card against the CPU Executor: the outputs within
    1e-5 of their largest magnitude, the gradients within 1e-4."""
    import paddle_tpu_torch as fluid
    op_type, inputs, outputs, attrs = RAGGED_CASES[key]
    rs = np.random.RandomState(7)
    shapes = {'sequence_pool': (5, 6), 'sequence_softmax': (10, 1),
              'sequence_pad': (5, 6, 6), 'sequence_reverse': (10, 6),
              'sequence_conv': (10, 5), 'lstm': (10, 4), 'gru': (10, 4)}
    weights = {n[0]: rs.randn(*shapes[op_type]).astype('float32')
               for n in outputs.values()}
    want = _ragged_op_run(fluid.CPUPlace(), op_type, inputs, outputs, attrs,
                          weights)
    got = _ragged_op_run(None, op_type, inputs, outputs, attrs, weights)
    for n, w in want.items():
        w = np.asarray(w)
        tol = (1e-4 if n.endswith('@GRAD') else 1e-5) * \
            max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(np.asarray(got[n]), w, rtol=0, atol=tol,
                                   err_msg=n)
        assert getattr(got[n], 'lod', list)() == \
            getattr(want[n], 'lod', list)(), n


def _small_lstm():
    import paddle_tpu_torch as fluid
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 1
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        words = fluid.layers.data(name='words', shape=[1], dtype='int64',
                                  lod_level=1)
        label = fluid.layers.data(name='label', shape=[1], dtype='int64')
        h = fluid.layers.embedding(words, size=[50, 8])
        for _ in range(2):
            h, _ = fluid.layers.dynamic_lstm(
                input=fluid.layers.fc(h, size=64), size=64)
        pred = fluid.layers.fc(fluid.layers.sequence_last_step(h), size=2,
                               act='softmax')
        loss = fluid.layers.mean(
            fluid.layers.cross_entropy(input=pred, label=label))
        fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, startup, loss


def _lstm_feeds(lens_list, seed=3):
    rs = np.random.RandomState(seed)
    out = []
    for lens in lens_list:
        lod = [[0] + [int(v) for v in np.cumsum(lens)]]
        out.append({'words': (rs.randint(0, 50, (lod[0][-1], 1))
                              .astype('int64'), lod),
                    'label': rs.randint(0, 2, (len(lens), 1))
                    .astype('int64')})
    return out


def test_ragged_bound_and_fused_steps_equal_run_calls(dev):
    """A two-layer stacked LSTM on ragged batches: ``bind`` and its calls,
    and ``run_fused`` over two LoDs in runs (A, A, B, A), against as many
    ``run()`` calls on another Executor from the same state: losses and
    state bitwise equal, one capture a LoD, one gather launch a step."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.io import scope_from_numpy
    main, startup, loss = _small_lstm()
    exe, s0 = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=s0)
    init = {n: s0.get(n).clone() for n in s0.names()}
    a, b = [3, 0, 1, 9], [2, 5, 5, 1]
    feeds = _lstm_feeds([a, a, b, a])
    ref = scope_from_numpy(init)
    want = [float(fluid.Executor().run(main, feed=f, fetch_list=[loss],
                                       scope=ref)[0][0]) for f in feeds]
    fused_exe = fluid.Executor()
    fused = scope_from_numpy(init)
    before = kernel_tier.launch_counts()
    last = fused_exe.run_fused(main, feeds, fetch_list=[loss], scope=fused)
    after = kernel_tier.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} \
        == {'embedding_gather': 4}
    plans = [e.bound[fused] for _, e in fused_exe._cache.items()
             if fused in e.bound]
    assert sorted(p.captures for p in plans) == [1, 1]
    assert float(last[0][0]) == want[-1]
    for n in init:
        assert torch.equal(fused.get(n), ref.get(n)), n
    bound = scope_from_numpy(init)
    bp = fluid.Executor().bind(main, feeds[0], fetch_list=[loss],
                               scope=bound)
    got = [float(bp.first_out[0][0])] + [float(bp(f)[0][0])
                                         for f in (feeds[1], feeds[3])]
    with pytest.raises(ValueError, match='LoD'):
        bp(feeds[2])
    ref2 = scope_from_numpy(init)
    e2 = fluid.Executor()
    want2 = [float(e2.run(main, feed=f, fetch_list=[loss],
                          scope=ref2)[0][0]) for f in (feeds[0], feeds[1],
                                                       feeds[3])]
    assert got == want2 and bp.captures == 1
    for n in init:
        assert torch.equal(bound.get(n), ref2.get(n)), n


# ---------------------------------------------------------------------------
# sparse embedding gradients (SelectedRows) and the CTR program


def _sparse_grad(dev, V, D, n, seed):
    """A SelectedRows of ``n`` rows of a [V, D] table (many repeats when V
    is small), with a sentinel row, on ``dev`` and on the CPU."""
    from paddle_tpu_torch.core.selected_rows import SelectedRows
    g = torch.Generator(device='cpu').manual_seed(seed)
    rows = torch.randint(0, V, (n,), generator=g)
    rows[-1] = V
    vals = torch.randn((n, D), generator=g)
    return (SelectedRows(rows.to(dev), vals.to(dev), V),
            SelectedRows(rows, vals, V))


@pytest.mark.parametrize('V,D', [(100000, 16), (50, 32), (50, 64)])
def test_sparse_merge_on_the_card_equals_the_cpu(dev, V, D):
    """``merged()`` and ``to_dense()`` on the card: the CPU's bits (each
    row's values summed in index order on both), the same bits at a
    second call; V 50 puts about 266 ids on a row."""
    card, cpu = _sparse_grad(dev, V, D, 13312, 20)
    rows, vals = card.merged()
    want_rows, want_vals = cpu.merged()
    assert torch.equal(rows.cpu(), want_rows)
    assert torch.equal(vals.cpu(), want_vals)
    again = card.merged()
    assert torch.equal(again[0], rows) and torch.equal(again[1], vals)
    assert torch.equal(card.to_dense().cpu(), cpu.to_dense())
    assert torch.equal(card.to_dense(), card.to_dense())


@pytest.mark.parametrize('update', ['sgd', 'momentum', 'nesterov', 'adam',
                                    'adagrad'])
def test_row_wise_updates_on_the_card_equal_the_cpu(dev, update):
    """Each lazy SelectedRows update on the card: the CPU's bits, twice
    the same bits from the same state, untouched rows as they were."""
    V, D = 5000, 16

    def step(g, where):
        gen = torch.Generator(device='cpu').manual_seed(21)
        state = [torch.randn((V, D), generator=gen).abs().to(where)
                 for _ in range(3)]
        lr = torch.tensor([0.05], device=where)
        p, a, b = state
        if update == 'sgd':
            optimizer_ops.sgd_rows(p, g, lr)
        elif update in ('momentum', 'nesterov'):
            optimizer_ops.momentum_rows(p, g, a, lr, 0.9,
                                        update == 'nesterov')
        elif update == 'adam':
            pows = [torch.tensor([v], device=where) for v in (0.81, 0.998)]
            optimizer_ops.adam(p, g, a, b, pows[0], pows[1], lr)
        else:
            optimizer_ops.adagrad_rows(p, g, a, lr)
        return [t.cpu() for t in state]

    card, cpu = _sparse_grad(dev, V, D, 13312, 22)
    got, want = step(card, dev), step(cpu, 'cpu')
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for a, b in zip(step(card, dev), got):
        assert torch.equal(a, b)
    gen = torch.Generator(device='cpu').manual_seed(21)
    init = torch.randn((V, D), generator=gen).abs()
    untouched = torch.ones(V, dtype=torch.bool)
    untouched[cpu.rows[cpu.rows < V]] = False
    assert untouched.any()
    assert torch.equal(got[0][untouched], init[untouched])


def _small_ctr(fluid, V=300, D=8, opt='adagrad'):
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 1
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids = fluid.layers.data(name='ids', shape=[26], dtype='int64')
        label = fluid.layers.data(name='label', shape=[1], dtype='float32')
        emb = fluid.layers.embedding(
            input=fluid.layers.reshape(ids, [-1, 26, 1]), size=[V, D],
            is_sparse=True)
        h = fluid.layers.fc(fluid.layers.reshape(emb, [-1, 26 * D]),
                            size=32, act='relu')
        p = fluid.layers.fc(h, size=1, act='sigmoid')
        loss = fluid.layers.mean(fluid.layers.log_loss(p, label))
        {'adagrad': lambda: fluid.optimizer.Adagrad(0.01),
         'adam': lambda: fluid.optimizer.Adam(1e-3, fuse=True),
         'momentum': lambda: fluid.optimizer.Momentum(0.05, 0.9)}[opt]() \
            .minimize(loss)
    return main, startup, loss


@pytest.mark.parametrize('opt', ['adagrad', 'adam', 'momentum'])
def test_sparse_fused_steps_equal_run_calls(dev, opt):
    """``run_fused`` over four CTR batches: four ``run()`` calls' losses
    and state bitwise, one capture, one gather launch a step."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.io import scope_from_numpy
    main, startup, loss = _small_ctr(fluid, opt=opt)
    exe, s0 = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=s0)
    init = {n: s0.get(n).clone() for n in s0.names()}
    rs = np.random.RandomState(5)
    feeds = [{'ids': rs.randint(0, 300, (16, 26)).astype('int64'),
              'label': (rs.rand(16, 1) > 0.5).astype('float32')}
             for _ in range(4)]
    ref = scope_from_numpy(init)
    want = [float(fluid.Executor().run(main, feed=f, fetch_list=[loss],
                                       scope=ref)[0][0]) for f in feeds]
    fused_exe, fused = fluid.Executor(), scope_from_numpy(init)
    before = kernel_tier.launch_counts()
    last = fused_exe.run_fused(main, feeds, fetch_list=[loss], scope=fused)
    after = kernel_tier.launch_counts()
    launched = {k: after[k] - before[k] for k in after
                if after[k] != before[k]}
    want_launches = {'embedding_gather': 4}
    if opt == 'adam':
        want_launches['fused_adam'] = 4
    assert launched == want_launches
    plans = [e.bound[fused] for _, e in fused_exe._cache.items()
             if fused in e.bound]
    assert [p.captures for p in plans] == [1]
    assert float(last[0][0]) == want[-1]
    for n in init:
        assert torch.equal(fused.get(n), ref.get(n)), n


# ---------------------------------------------------------------------------
# The learning-rate schedules' step counter and the activation ops (slice 26)

def _scheduled_program(fluid):
    """An fc regression under ``Adam(learning_rate=noam_decay(16, 3))``:
    the step counter's ``increment`` at the top of every run."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 4
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data('x', shape=[8])
        y = fluid.layers.data('y', shape=[1])
        loss = fluid.layers.mean(fluid.layers.square_error_cost(
            fluid.layers.fc(x, size=1), y))
        lr = fluid.layers.learning_rate_scheduler.noam_decay(16, 3)
        fluid.optimizer.Adam(learning_rate=lr).minimize(loss)
    return main, startup, loss, lr


def _htod_copies(fn):
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if 'HtoD' in e.key)


def test_bound_step_counter_copies_nothing_from_the_host(dev):
    """A bound program whose rate is a schedule of the step counter: the
    ``increment`` adds its step as a number, so a replay (feeds already on
    the card) copies nothing from the host, and the rate advances with
    every replay along noam's closed form (1e-6 relative), the counter an
    int64 at the number of steps."""
    import paddle_tpu_torch as fluid
    main, startup, loss, lr = _scheduled_program(fluid)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    rs = np.random.RandomState(2)
    feed = {'x': torch.from_numpy(rs.randn(4, 8).astype('float32')).to(dev),
            'y': torch.from_numpy(rs.randn(4, 1).astype('float32')).to(dev)}
    bp = exe.bind(main, feed, fetch_list=[loss, lr], scope=scope)
    rates = [float(bp.first_out[1][0])]
    for _ in range(2):
        rates.append(float(bp(feed)[1][0]))
    replayed = []
    assert _htod_copies(lambda: replayed.append(bp(feed))) == 0
    rates.append(float(replayed[0][1][0]))
    assert bp.replays >= 2 and bp.captures == 1
    for s, r in enumerate(rates, start=1):
        want = 16 ** -0.5 * min(s ** -0.5, s * 3 ** -1.5)
        assert abs(r / want - 1) <= 1e-6, (s, r, want)
    counter = scope.get('@LR_DECAY_COUNTER@')
    assert counter.dtype == torch.int64 and int(counter[0]) == 4


def test_fused_steps_with_a_step_counter_equal_run_calls(dev):
    """``run_fused`` over four batches under a scheduled rate: the four
    ``run()`` calls' losses and state bitwise, the counter at 4."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.io import scope_from_numpy
    main, startup, loss, lr = _scheduled_program(fluid)
    exe, s0 = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=s0)
    init = {n: s0.get(n).clone() for n in s0.names()}
    rs = np.random.RandomState(3)
    feeds = [{'x': rs.randn(4, 8).astype('float32'),
              'y': rs.randn(4, 1).astype('float32')} for _ in range(4)]
    ref = scope_from_numpy(init)
    want = [exe.run(main, feed=f, fetch_list=[loss, lr], scope=ref)
            for f in feeds]
    fused = scope_from_numpy(init)
    last = fluid.Executor().run_fused(main, feeds, fetch_list=[loss, lr],
                                      scope=fused)
    assert np.array_equal(last[0], want[-1][0])
    assert np.array_equal(last[1], want[-1][1])
    for n in init:
        assert torch.equal(fused.get(n), ref.get(n)), n
    assert int(fused.get('@LR_DECAY_COUNTER@')[0]) == 4


ACT_CASES = torch_activation_cases.cases()


@pytest.mark.parametrize('key', sorted(ACT_CASES))
def test_activation_op_on_the_card_matches_the_cpu(dev, key):
    """Each activation and math op type of tests/torch_activation_cases.py
    through ``Executor.run`` on the card against the port's CPU Executor:
    the outputs and the gradients of sum(out * ct), within rtol 1e-5 and
    atol 1e-6 (the card's exp, log, tanh, pow and cos are correctly
    rounded to within a few ulps, and its sums run in another order)."""
    import paddle_tpu_torch as fluid
    case, tac = ACT_CASES[key], torch_activation_cases
    want = tac.run_case(fluid, fluid.Executor(fluid.CPUPlace()), key, case)
    got = tac.run_case(fluid, fluid.Executor(), key, case)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].shape == want[name].shape, name
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def _loop_setup(bound, train=False):
    import paddle_tpu_torch as fluid
    main, startup, fetch = torch_loop_cases.loop_program(fluid, bound, train)
    exe = fluid.Executor()
    scopes = [fluid.Scope(), fluid.Scope()]
    for s in scopes:
        exe.run(startup, scope=s)
    return fluid, exe, main, fetch, scopes


@pytest.mark.parametrize('train', [False, True])
def test_bound_while_replays_equal_eager_runs(dev, train):
    """A While(max_trip_count=8) bound on the card: one capture, and its
    replays at 3, 5, 8 and 1 trips equal ``run()`` on the card bitwise (an
    eager host loop, or under the backward the bounded loop), the trained
    parameter too; a replay copies nothing from the host once the feed is
    on the card."""
    fluid, exe, main, fetch, scopes = _loop_setup(8, train)
    feeds = [{k: torch.from_numpy(v).to(dev) for k, v in f.items()}
             for f in torch_loop_cases.loop_feeds((3, 5, 8, 1))]
    ref = [exe.run(main, feed=f, fetch_list=fetch, scope=scopes[0])
           for f in feeds]
    bp = exe.bind(main, feeds[0], fetch_list=fetch, scope=scopes[1])
    got = [bp.first_out] + [bp(f) for f in feeds[1:]]
    assert bp.captures == 1 and bp.replays == 3
    for r, g in zip(ref, got):
        for a, b in zip(r, g):
            np.testing.assert_array_equal(b, a)
    assert [int(r[2][0]) for r in ref] == [3, 5, 8, 1]
    assert torch.equal(scopes[1].get('loop.w'), scopes[0].get('loop.w'))
    assert _htod_copies(lambda: bp(feeds[1])) == 0


@pytest.mark.parametrize('bound', [None, 4])
def test_bound_while_runs_to_its_condition_in_one_graph(dev, bound):
    """A While with no bound, and one whose condition holds past its
    max_trip_count of 4, bound on the card: one capture (the loop one WHILE
    node of the step's graph), replays at 6, 0, 8 and 2 trips equal to
    ``run()`` on the card bitwise (``lax.while_loop``: the bound does not
    cut it), ``run_fused`` over the same feeds equal to the last, the trip
    counter at the replays' trips and no host-to-device copy in a
    replay."""
    fluid, exe, main, fetch, scopes = _loop_setup(bound)
    trips = (3, 6, 0, 8, 2)
    feeds = [{k: torch.from_numpy(v).to(dev) for k, v in f.items()}
             for f in torch_loop_cases.loop_feeds(trips)]
    ref = [exe.run(main, feed=f, fetch_list=fetch, scope=scopes[0])
           for f in feeds]
    bp = exe.bind(main, feeds[0], fetch_list=fetch, scope=scopes[1])
    got = [bp.first_out] + [bp(f) for f in feeds[1:]]
    assert bp.captures == 1 and bp.replays == len(trips) - 1
    assert bp.loop_launches()[1] == [sum(trips[1:])]
    for r, g in zip(ref, got):
        for a, b in zip(r, g):
            np.testing.assert_array_equal(b, a)
    assert [int(r[2][0]) for r in ref] == list(trips)
    fused = exe.run_fused(main, feeds, fetch_list=fetch, scope=scopes[1])
    for a, b in zip(ref[-1], fused):
        np.testing.assert_array_equal(b, a)
    assert _htod_copies(lambda: bp(feeds[1])) == 0


def _on_card(trips, dev):
    return [{k: torch.from_numpy(v).to(dev) for k, v in f.items()}
            for f in torch_loop_cases.loop_feeds(trips)]


def test_bound_training_while_past_its_inferred_bound_raises(dev):
    """A differentiated While bounded by its array's capacity of 8, bound
    on the card: a replay whose feed needs 10 trips raises RuntimeError
    after it (the capture ORs the final condition into a device flag, read
    after each call), the next replay at 3 trips runs and equals ``run()``
    from the same state, and ``run_fused`` over a feed of 10 trips
    raises."""
    fluid, exe, main, fetch, scopes = _loop_setup(None, train=True)
    feeds = _on_card((5, 3, 10), dev)
    cut = 'inferred trip-count bound 8'
    bp = exe.bind(main, feeds[0], fetch_list=fetch, scope=scopes[1])
    bp(feeds[1])
    with pytest.raises(RuntimeError, match=cut):
        bp(feeds[2])
    assert bp.captures == 1
    scopes[0].set('loop.w', scopes[1].get('loop.w').clone())
    want = exe.run(main, feed=feeds[1], fetch_list=fetch, scope=scopes[0])
    for a, b in zip(want, bp(feeds[1])):
        np.testing.assert_array_equal(b, a)
    with pytest.raises(RuntimeError, match=cut):
        exe.run_fused(main, feeds, fetch_list=fetch, scope=scopes[1])


def test_bound_while_that_draws_replays_equal_eager_runs(dev):
    """A While whose body draws (a seeded uniform and one from the run's
    generator), with no bound and with a max_trip_count of 4 that its
    trips pass, bound and fused on the card: one capture, the loop one
    WHILE node whose trips draw what ``run()`` draws in them (each trip
    advances the generators' device offsets, core/graphs.py `run_while`),
    so the bind step and the replays at 3, 0 and 12 trips, and
    ``run_fused`` over them, equal ``run()`` on the card bitwise, with a
    different draw in each trip and no raise past the bound."""
    import paddle_tpu_torch as fluid
    trips = (3, 0, 12, 3)
    feeds = _on_card(trips, dev)
    for bound in (None, 4):
        main, startup, fetch = torch_loop_cases.loop_program(fluid, bound,
                                                             noise='run')
        # two executors count the same run indices, so the run's generator
        # is seeded alike in both
        exes = [fluid.Executor(), fluid.Executor()]
        scopes = [fluid.Scope(), fluid.Scope()]
        for exe, sc in zip(exes, scopes):
            exe.run(startup, scope=sc)
        ref = [exes[0].run(main, feed=f, fetch_list=fetch, scope=scopes[0])
               for f in feeds]
        bp = exes[1].bind(main, feeds[0], fetch_list=fetch, scope=scopes[1])
        got = [bp.first_out] + [bp(f) for f in feeds[1:]]
        assert bp.captures == 1 and bp.replays == len(trips) - 1
        assert bp.loop_launches()[1] == [sum(trips[1:])]
        for r, g in zip(ref, got):
            for a, b in zip(r, g):
                np.testing.assert_array_equal(b, a)
        assert [int(r[2][0]) for r in ref] == list(trips)
        drawn = ref[2][-1]
        assert len(np.unique(drawn, axis=0)) == 8
        fused = exes[1].run_fused(main, feeds, fetch_list=fetch,
                                  scope=scopes[1])
        want = [exes[0].run(main, feed=f, fetch_list=fetch, scope=scopes[0])
                for f in feeds][-1]
        for a, b in zip(want, fused):
            np.testing.assert_array_equal(b, a)


def test_nmt_run_steps_are_bitwise_from_run_to_run(dev):
    """The machine-translation training step (bi-LSTM encoder, DynamicRNN
    decoder attending with sequence_expand and sequence_softmax, Adam) at
    V 1000, widths 128, on ragged batches of repeated ids: two sequences
    of three ``run()`` steps from one initialization (one startup run,
    copied into two scopes) give the same state, bit for bit (each gather
    that repeats rows adds its gradient in index order,
    ops/sequence_ops.py `gather_rows`)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models.seq2seq import (Seq2SeqConfig,
                                                 build_nmt_train)
    cfg = Seq2SeqConfig(dict_size=1000, embedding_dim=128, encoder_size=128,
                        decoder_size=128)
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 3
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        names, loss, _ = build_nmt_train(cfg)
        fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    rs = np.random.RandomState(4)
    lens = [7, 3, 5, 9, 12, 4, 8, 6]
    lod = [[0] + [int(v) for v in np.cumsum(lens)]]
    batches = [{n: (torch.from_numpy(rs.randint(1, 20, (lod[0][-1], 1))
                                     .astype('int64')).to(dev), lod)
                for n in names} for _ in range(3)]
    from paddle_tpu_torch.io import scope_from_numpy
    exe = fluid.Executor()
    init = fluid.Scope()
    exe.run(startup, scope=init)
    init = {n: init.get(n).detach().cpu().numpy() for n in init.names()}
    states = []
    for _ in range(2):
        scope = scope_from_numpy(init, device=dev)
        for b in batches:
            exe.run(main, feed=b, fetch_list=[loss], scope=scope)
        states.append({n: scope.get(n).detach().cpu().numpy()
                       for n in scope.names()})
    assert sorted(states[0]) == sorted(states[1])
    for n in states[0]:
        np.testing.assert_array_equal(states[1][n], states[0][n],
                                      err_msg=n)


# ---------------------------------------------------------------------------
# training health and fault tolerance on the card (resilience.py, health.py,
# FLAGS_check_nan_inf, the aliasing rule of core/lowering.py)


def test_bound_step_rollback_leaves_the_next_replay_equal_to_eager(dev):
    """A `TrainingGuard` snapshot and rollback around a bound call (the
    flash program with dropout 0.1): the rollback copies the state back
    into the tensors the graph holds and rewinds the run counter, so the
    next replay follows the eager ``run()`` trajectory that never took
    the rolled-back step (the same masks), at the bound step's limits."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import resilience
    from paddle_tpu_torch.io import scope_from_numpy
    feeds = _bound_lm_feeds(4)
    main, startup, loss = _bound_lm(0.1)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    init = {n: scope.get(n).clone() for n in scope.names()}
    want = [float(exe.run(main, feed=f, fetch_list=[loss],
                          scope=scope)[0][0]) for f in (feeds[0], feeds[2],
                                                        feeds[3])]
    main, _, loss = _bound_lm(0.1)
    exe, bscope = fluid.Executor(), scope_from_numpy(init)
    bp = exe.bind(main, feeds[0], fetch_list=[loss], scope=bscope)
    got = [float(bp.first_out[0][0])]
    guard = resilience.TrainingGuard(exe, main, loss_name=loss.name,
                                     scope=bscope)
    held = {n: bscope.get(n) for n in bscope.names()}
    snap = guard._snapshot(bscope)
    before = {n: t.clone() for n, t in held.items()}
    bp(feeds[1])                              # the step rolled back
    assert any(not torch.equal(before[n], held[n]) for n in held)
    guard._restore(bscope, snap)
    for n, t in held.items():
        assert bscope.get(n) is t and torch.equal(t, before[n]), n
    for f in feeds[2:]:
        got.append(float(bp(f)[0][0]))
    assert bp.captures == 1
    _hold_bound_to_eager(got, want, bscope, scope,
                         [p.name for p in main.all_parameters()])


def _poison_program(kind=None):
    """(main, startup, loss, copy) of an fc + mean program whose loss has a
    float [1] feed ``poison`` added, under SGD(0.5); ``kind`` names the op
    (assign, cast, reshape, transpose) whose copy of the weight, taken
    before minimize, is ``copy``."""
    import paddle_tpu_torch as fluid
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name='x', shape=[8], dtype='float32')
        p = fluid.layers.data(name='poison', shape=[1], dtype='float32',
                              append_batch_size=False)
        h = fluid.layers.fc(x, size=16, act='relu',
                            param_attr=fluid.ParamAttr(name='w'))
        w = main.global_block().var('w')
        copy = None
        if kind == 'assign':
            copy = fluid.layers.assign(w)
        elif kind == 'cast':
            copy = fluid.layers.cast(w, 'float32')
        elif kind == 'reshape':
            copy = fluid.layers.reshape(w, shape=[-1])
        elif kind == 'transpose':
            copy = fluid.layers.transpose(w, perm=[1, 0])
        loss = fluid.layers.elementwise_add(
            fluid.layers.mean(fluid.layers.fc(h, size=1)), p)
        fluid.optimizer.SGD(0.5).minimize(loss)
    return main, startup, loss, copy


def _poison_feeds(n, bad=()):
    rs = np.random.RandomState(2)
    return [{'x': rs.randn(4, 8).astype('float32'),
             'poison': np.full((1,), np.nan if i in bad else 0.0,
                               np.float32)} for i in range(n)]


def test_captured_check_nan_inf_flags_name_the_run_variables(dev):
    """``FLAGS_check_nan_inf`` under a CUDA graph: a plan bound with the
    flag on computes a flag a variable inside the graph (its vector is
    read after the call); a bound call and a ``run_fused`` window holding
    the poisoned batch raise naming what ``run()`` names, and the next
    good call does not raise."""
    import re
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import flags
    main, startup, loss, _ = _poison_program()
    feeds = _poison_feeds(4, bad=(1,))

    def names(err):
        return re.search(r'detected in (\[.*?\])', str(err)).group(1)

    flags.set_flags('check_nan_inf', True)
    try:
        exe = fluid.Executor()
        got = {}
        for how in ('run', 'bind', 'run_fused'):
            scope = fluid.Scope()
            exe.run(startup, scope=scope)
            with pytest.raises(RuntimeError, match='NaN/Inf') as e:
                if how == 'run':
                    for f in feeds:
                        exe.run(main, feed=f, fetch_list=[loss],
                                scope=scope)
                elif how == 'bind':
                    bp = exe.bind(main, feeds[0], fetch_list=[loss],
                                  scope=scope)
                    assert bp.captures == 1
                    assert bp._plan.nan_acc is not None
                    bp(feeds[1])
                else:
                    exe.run_fused(main, feeds[:3], fetch_list=[loss],
                                  scope=scope)
            got[how] = names(e.value)
        assert got['bind'] == got['run'] == got['run_fused']
        assert 'elementwise_add' in got['run']
        bp(feeds[2])                     # the flags were zeroed: no raise
        assert bp.replays >= 2
    finally:
        flags.set_flags('check_nan_inf', False)


@pytest.mark.parametrize('kind', ['assign', 'cast', 'reshape', 'transpose'])
def test_copy_of_a_parameter_keeps_its_pre_update_value_under_capture(
        dev, kind):
    """core/lowering.py's aliasing rule in a CUDA graph: a copy of the
    weight taken before ``minimize`` (through an op whose lowering can
    return its input or a view) is the weight before the step's SGD
    update, in the bind step, each replay and each ``run_fused`` step,
    as in ``run()`` (and in the JAX package)."""
    import paddle_tpu_torch as fluid
    main, startup, loss, copy = _poison_program(kind)
    feeds = _poison_feeds(4)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)

    def shaped(w):
        w = w.cpu().numpy().copy()
        return {'assign': w, 'cast': w, 'reshape': w.reshape(-1),
                'transpose': w.T}[kind]

    w0 = shaped(scope.get('w'))
    bp = exe.bind(main, feeds[0], fetch_list=[copy, loss], scope=scope)
    np.testing.assert_array_equal(bp.first_out[0], w0)
    for f in feeds[1:]:
        w0 = shaped(scope.get('w'))
        out = bp(f)
        np.testing.assert_array_equal(out[0], w0)
        assert not np.array_equal(shaped(scope.get('w')), w0)
    for f in feeds[:3]:                  # the first call captures
        w0 = shaped(scope.get('w'))
        out = exe.run_fused(main, [f], fetch_list=[copy], scope=scope)
        np.testing.assert_array_equal(out[0], w0)
