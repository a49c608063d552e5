"""The numeric premise of the port's tensor-core kernels, held on the CPU.

``csrc/ffn_gemm.cu`` (tile route), ``csrc/flash_attn_fwd.cu`` and
``csrc/flash_attn_bwd.cu`` run their f32 products on the tensor cores as
three TF32 products: a = big + small,
a·b ~ small_a·big_b + big_a·small_b + big_a·big_b. One TF32 product keeps 10
mantissa bits, which at these depths misses the kernels' 1e-4 tolerance
against their f32 plain versions; three keep f32-level accuracy. Here the
splits are emulated bit for bit (the kernels' own: big = x with its low 13
mantissa bits cleared, small = x - big, and the tensor cores reading only
the top 10 mantissa bits of an operand; and the round-to-nearest form of
`cvt.rna.tf32.f32`, ties away from zero), the passes are multiplied exactly
in float64, and the result is held against the float64 product, at the
depths and the input scales of the port's main paths (``chip_smoke.py``).

Also here: the FFN wrapper's launch plan, a function of the shapes alone,
fills an H100's 132 SMs at every main-path shape.
"""
import functools

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import ffn_ops

TOL = 1e-4   # the kernels' tolerance against their f32 plain versions


def _cut(x):
    """What the tensor cores read of an f32 operand: its low 13 mantissa
    bits dropped."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def _rna(x):
    """`cvt.rna.tf32.f32`: round to 10 mantissa bits, to nearest, ties
    away from zero (on the magnitude bits, so for either sign)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _split(x, scheme):
    if scheme == 'cut':      # the kernels' split
        big = _cut(x)
        return big, _cut(x - big)
    big = _rna(x)
    return big, _rna(x - big)


def _three_pass(a, b, scheme):
    (ab, asm), (bb, bsm) = _split(a, scheme), _split(b, scheme)
    d = torch.float64
    return (asm.to(d) @ bb.to(d) + ab.to(d) @ bsm.to(d)
            + ab.to(d) @ bb.to(d))


def _one_pass(a, b):
    return _cut(a).double() @ _cut(b).double()


def _gelu(x):
    return 0.5 * x * torch.special.erfc(-x * np.sqrt(0.5))


def _ffn_operands(rows, d, d_ff, seed):
    """x and the FFN's weights at chip_smoke.py's scales: x ~ N(0, 1),
    weights and biases ~ N(0, 0.02^2); h is GEMM 2's input."""
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.randn(rows, d).astype('float32'))
    w1 = torch.from_numpy((rs.randn(d, d_ff) * 0.02).astype('float32'))
    b1 = torch.from_numpy((rs.randn(d_ff) * 0.02).astype('float32'))
    w2 = torch.from_numpy((rs.randn(d_ff, d) * 0.02).astype('float32'))
    h = _gelu(x @ w1 + b1)
    return x, w1, h, w2


@pytest.mark.parametrize('scheme', ['cut', 'rna'])
@pytest.mark.parametrize('d,d_ff', [(512, 2048), (768, 3072)],
                         ids=['lm', 'bert'])
def test_three_tf32_passes_keep_the_ffn_products_within_tolerance(
        scheme, d, d_ff):
    """K 512 and 2048 (the LM), 768 and 3072 (BERT): three passes within
    a tenth of 1e-4 of float64, one pass outside 1e-4."""
    x, w1, h, w2 = _ffn_operands(64, d, d_ff, seed=d)
    for a, b in ((x, w1), (h, w2)):
        exact = a.double() @ b.double()
        three = float((_three_pass(a, b, scheme) - exact).abs().max())
        one = float((_one_pass(a, b) - exact).abs().max())
        assert three <= TOL / 10, (a.shape, three)
        assert one > TOL, (a.shape, one)


@pytest.mark.parametrize('scheme', ['cut', 'rna'])
def test_three_tf32_passes_keep_the_flash_products_within_tolerance(scheme):
    """The flash forward's two products at the LM's training shape (dh 64,
    512 keys, causal), q, k, v ~ N(0, 1) as chip_smoke.py draws them: the
    scaled scores S = Q K^T / 8 and O = P V with P the causal softmax."""
    rs = np.random.RandomState(5)
    q, k, v = (torch.from_numpy(rs.randn(512, 64).astype('float32'))
               for _ in range(3))
    s_exact = q.double() @ k.double().t() / 8
    s3 = _three_pass(q, k.t().contiguous(), scheme) / 8
    s1 = _one_pass(q, k.t().contiguous()) / 8
    assert float((s3 - s_exact).abs().max()) <= TOL / 10
    assert float((s1 - s_exact).abs().max()) > TOL
    causal = torch.ones(512, 512, dtype=torch.bool).tril()
    p = torch.softmax(s_exact.masked_fill(~causal, -np.inf), dim=1).float()
    o_exact = p.double() @ v.double()
    assert float((_three_pass(p, v, scheme) - o_exact).abs().max()) <= \
        TOL / 10
    assert float((_one_pass(p, v) - o_exact).abs().max()) > TOL


@functools.lru_cache(maxsize=1)
def _flash_bwd_products():
    """The flash backward's three gradient products at the LM's training
    shape (dh 64, 512 queries and keys, causal), q, k, v, dO ~ N(0, 1) as
    chip_smoke.py draws them, P and dS formed in float64 and handed to the
    products in f32 as the kernels hold them: {name: (A, B)} of dQ = dS K,
    dK = dS^T Q and dV = P^T dO, each 512 deep."""
    rs = np.random.RandomState(5)
    q, k, v, do = (torch.from_numpy(rs.randn(512, 64).astype('float32'))
                   for _ in range(4))
    s = q.double() @ k.double().t() / 8
    causal = torch.ones(512, 512, dtype=torch.bool).tril()
    p = torch.softmax(s.masked_fill(~causal, -np.inf), dim=1)
    dp = do.double() @ v.double().t()
    delta = (do.double() * (p @ v.double())).sum(dim=1, keepdim=True)
    p, ds = p.float(), (p * (dp - delta) / 8).float()
    return {'dq': (ds, k), 'dk': (ds.t().contiguous(), q),
            'dv': (p.t().contiguous(), do)}


def _tiled(a, b, product, tile=64):
    """a @ b as the backward kernels sum it: each 64-deep tile's product in
    a fresh f32 fragment, the fragments added in f32 in tile order."""
    acc = torch.zeros(a.shape[0], b.shape[1])
    for i in range(0, a.shape[1], tile):
        acc = acc + product(a[:, i:i + tile].contiguous(),
                            b[i:i + tile]).float()
    return acc


@pytest.mark.parametrize('product', ['dq', 'dk', 'dv'])
@pytest.mark.parametrize('scheme', ['cut', 'rna'])
def test_three_tf32_passes_keep_the_flash_backward_products_within_tolerance(
        scheme, product):
    """dQ = dS K, dK = dS^T Q and dV = P^T dO at the LM's training shape,
    summed over 64-row tiles as the kernels sum them: three passes within
    1e-5 of the product's largest magnitude from the float64 product, one
    pass outside 1e-4 of it."""
    a, b = _flash_bwd_products()[product]
    exact = a.double() @ b.double()
    top = float(exact.abs().max())
    three = _tiled(a, b, lambda x, y: _three_pass(x, y, scheme))
    one = _tiled(a, b, _one_pass)
    assert float((three - exact).abs().max()) <= 1e-5 * top
    assert float((one - exact).abs().max()) > TOL * top


def test_the_split_is_exact_where_it_must_be():
    """big + small == x for the kernels' split (small keeps x's low 13
    bits, at most 13 significant bits), and what the tensor cores drop of
    small is below 2^-20 of x."""
    x = torch.from_numpy(np.random.RandomState(1).randn(4096)
                         .astype('float32'))
    big = _cut(x)
    small = x - big
    assert torch.equal(big + small, x)
    assert bool(((small - _cut(small)).abs() <= x.abs() * 2.0 ** -20).all())


MAIN_SHAPES = [(rows, d, d_ff) for d, d_ff in ((512, 2048), (768, 3072))
               for rows in (8, 64, 128, 256, 4096, 8192, 16384)]


@pytest.mark.parametrize('rows,d,d_ff', MAIN_SHAPES)
def test_ffn_plan_fills_the_card_at_every_main_path_shape(rows, d, d_ff):
    """The decode step (8 rows) takes the skinny route with a slice per
    block; prefill (64-256 rows) and training or inference batches take the
    tile route, split along K where the tiles alone give too few blocks.
    Either way the card's 132 SMs get at least _FILL (128) blocks, and a
    split's chunks cover K exactly once."""
    plan = ffn_ops._plan(rows, d, d_ff, d)
    assert plan == ffn_ops._plan(rows, d, d_ff, d)
    if rows <= ffn_ops._SKINNY_MAX_ROWS:
        assert plan == ('skinny', d_ff // ffn_ops._SKINNY_SLICE)
        assert plan[1] >= ffn_ops._FILL
        return
    assert plan[0] == 'tile'
    for (tile, splits, chunk), (n, k) in zip(plan[1:], ((d_ff, d),
                                                        (d, d_ff))):
        bm, bn = (64, 128) if tile == 1 else (64, 64)
        blocks = -(-rows // bm) * -(-n // bn) * splits
        assert blocks >= ffn_ops._FILL, (tile, splits, blocks)
        assert chunk % 32 == 0 and (splits - 1) * chunk < k <= \
            splits * chunk


def test_ffn_plan_depends_on_the_row_count_alone():
    """At one model's widths the route is a step function of the row count
    (so every call at a call site, with its fixed row count, takes one
    route): skinny up to the limit, tile above it."""
    routes = [ffn_ops._plan(n, 512, 2048, 512)[0] for n in range(1, 65)]
    limit = ffn_ops._SKINNY_MAX_ROWS
    assert routes == ['skinny'] * limit + ['tile'] * (64 - limit)
    # the skinny kernel holds x in shared memory: widths it cannot hold
    # take the tile route at any row count
    assert ffn_ops._plan(8, 16384, 2048, 512)[0] == 'tile'
