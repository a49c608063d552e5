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
version's (1e-6 for the CE gradient, a probability times ct).
"""
import pytest
import torch

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


@pytest.mark.parametrize('D', [128, 130, 3])
def test_embedding_gather_kernel(dev, D):
    w = _randn(dev, 50, D)
    ids = torch.tensor([0, 49, -7, 60, 13, 13], device=dev)
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


def test_flash_attention_kernel_rejects_bias_and_odd_head_width(dev):
    q = _randn(dev, 1, 2, 8, 64)
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        attention_ops.flash_attention(q, q, q, key_padding_bias=torch.zeros(
            1, 8, device=dev))
    q = _randn(dev, 2, 8, 48)
    with pytest.raises(ValueError, match='head width'):
        attention_ops.flash_attention(q, q, q)


@pytest.mark.parametrize('n,d,f,with_mask', [(1, 64, 128, False),
                                             (70, 100, 200, True),
                                             (8, 512, 2048, False)])
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
                                 (5, 3)])
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
    cfg = LMConfig(vocab_size=64, seq_len=16, d_model=64, n_head=2,
                   n_layer=1, d_ff=64, dropout=0.0)
    m = TransformerLM(cfg, init_params(cfg, 0, dev), 16)
    tok = torch.zeros(1, 16, dtype=torch.long, device=dev)
    with pytest.raises(NotImplementedError, match='slice 3'):
        m.loss(tok, tok)


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
