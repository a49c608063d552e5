"""paddle_tpu_torch's CUDA kernels against their plain PyTorch versions, on
the card, at ragged shapes the engine's own shapes do not reach (rows, keys
and widths that are not multiples of the tiles). Marked ``cuda``: each test
skips without a card; on one, run

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest imports jax, which the card's
machine need not have; this file imports only the port.)

Tolerances: exact for the gather (a copy) and for Adam (the same
correctly rounded IEEE operations in the same order); 1e-4 absolute for the
other f32 kernels, whose sums run in another order than the plain
version's (1e-6 for the CE gradient, a probability times ct); the flash
backward's gradients within 1e-4 of each tensor's largest magnitude.
"""
import pytest
import torch

from paddle_tpu_torch.models import bert
from paddle_tpu_torch.models.transformer import (LMConfig, TransformerLM,
                                                 init_params)
from paddle_tpu_torch.ops import (attention_ops, ce_ops, embedding_ops,
                                  ffn_ops, kernel_tier, nn_ops,
                                  optimizer_ops)

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


@pytest.mark.parametrize('V,D', [(50, 128), (50, 130), (50, 3), (2, 768)])
def test_embedding_gather_kernel(dev, V, D):
    w = _randn(dev, V, D)
    ids = torch.tensor([0, 49, -7, 60, 13, 13, 1], device=dev)
    bias = _randn(dev, D, seed=1)
    before = kernel_tier.launch_counts()['embedding_gather']
    for b in (None, bias):
        got = embedding_ops.embedding_gather(w, ids, b)
        torch.cuda.synchronize()
        assert torch.equal(got, embedding_ops._gather_ref(w, ids, b))
    assert kernel_tier.launch_counts()['embedding_gather'] == before + 2


@pytest.mark.parametrize('n,D', [(1, 96), (13, 512), (37, 1000), (5, 4096)])
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
    q = _randn(dev, 2, 8, 48)
    with pytest.raises(ValueError, match='head width'):
        attention_ops.flash_attention(q, q, q)


@pytest.mark.parametrize('n,d,f,with_mask', [(1, 64, 128, False),
                                             (70, 100, 200, True),
                                             (8, 512, 2048, False),
                                             (300, 768, 3072, True)])
def test_fused_ffn_kernel(dev, n, d, f, with_mask):
    x = _randn(dev, n, d)
    w1, b1 = _randn(dev, d, f, scale=0.05, seed=1), _randn(dev, f, seed=2)
    w2, b2 = _randn(dev, f, d, scale=0.05, seed=3), _randn(dev, d, seed=4)
    mask = (_randn(dev, n, d, seed=5) > 0).float() if with_mask else None
    y, pre1 = ffn_ops.fused_ffn_core(x, w1, b1, w2, b2, mask,
                                     want_pre1=True)
    y_ref, pre1_ref = ffn_ops._ffn_ref(x, w1, b1, w2, b2, mask)
    torch.cuda.synchronize()
    assert _err(y, y_ref) <= 1e-4 and _err(pre1, pre1_ref) <= 1e-4


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


@pytest.mark.parametrize('n,D', [(13, 256), (3, 4096), (37, 1000),
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


def test_flash_training_on_the_card_raises_naming_slice_3(dev):
    """Flash-on training (attention dropout 0) on the card runs the three
    flash kernels, once a layer each, and matches the unfused branch."""
    from paddle_tpu_torch.optimizer import Adam
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
        Adam(m.p, 1e-3, fuse=True).step()
    assert abs(res[True][0] - res[False][0]) <= 1e-5
    assert _err(res[True][1], res[False][1]) <= \
        1e-4 * float(res[False][1].abs().max())


def test_bert_step_goes_through_the_kernels(dev):
    """A BERT training step on the card launches every kernel of its path
    (the flash three once a layer, with the padding bias), and its
    inference losses equal the CPU's."""
    import numpy as np
    from paddle_tpu_torch.optimizer import Adam
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
    opt = Adam(m.p, 1e-3, fuse=True)
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
    from paddle_tpu_torch.optimizer import Adam
    cfg = LMConfig(vocab_size=300, seq_len=24, d_model=64, n_head=2,
                   n_layer=2, d_ff=128)
    m = TransformerLM(cfg, init_params(cfg, 0, dev), 24)
    opt = Adam(m.p, 1e-3, fuse=True)
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
