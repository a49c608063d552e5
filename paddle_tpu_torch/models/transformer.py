"""The flagship causal LM: the program builder, the training forward and
decode.

`build_lm` (with `multi_head_attention`, `transformer_block`, `_entry_ln`
and `_ffn_tail`) is the port's own copy of the JAX builder: it appends the
same ops to the default programs through the port's `layers`, and the
Executor runs them (executor.py). The rest of the module is the same model
as an ``nn.Module`` for the paths that run without a Program.

Counterpart of paddle_tpu/models/transformer.py: `LMConfig`, `build_lm`
(the training program's forward, up to the mean loss), the decode programs
`build_lm_prefill`, `build_lm_prefill_paged` and `build_lm_decode_step`
(with `_decode_tower`, in both cache modes) and speculative decoding's
`build_lm_drafter` and `build_lm_verify` on the paged cache. Both
packages build these as Programs (the port's copies of the build
functions bind with `Executor.bind`); the decode engine runs the same towers as
:class:`TransformerLM`, an ``nn.Module`` whose parameters carry the JAX
package's names (``tok_emb.w``, ``layer_{i}.attn.qkv.w``, ...) and
layouts — fc weights
stay [in, out], so ``y = x @ W + b`` — so a scope saved by the JAX package
loads as it is (paddle_tpu_torch/io.py). The backward of `build_lm`'s
program is ``torch.autograd`` over :meth:`TransformerLM.loss`.

The residual wiring is the JAX package's: each block's FFN output is left
unadded and fused into the NEXT LayerNorm (``fused_ln_residual``); the final
LayerNorm is fused with the last block's delta. Training puts a zero delta
(``x * 0``) ahead of block 0, so every block's entry LayerNorm is a fused
site (2·L + 1 per forward); decode keeps one plain ``layer_norm`` at layer
0's entry, as the decode programs do.

The KV cache is two tensors owned by the module, allocated zeroed and
updated in place: [slots, layers, heads, max_len, head_dim]
(:meth:`TransformerLM.allocate_cache`), or a pool of [num_blocks, layers,
heads, block_size, head_dim] blocks addressed through block tables
(:meth:`TransformerLM.allocate_paged_cache`).

:class:`TransformerStack` holds what the LM shares with BERT
(paddle_tpu_torch/models/bert.py), as `transformer_block` serves both
models in the JAX package: the parameters under their JAX names and the
pre-norm block of the training forward.

Mixed precision: ``TransformerStack.amp`` maps an op type to its AMP dtype
for the sites that `contrib.mixed_precision.rewrite_model_bf16` marked
(empty: everything float32). The sites are the counterparts of the JAX
program's ops: every fc's ``mul`` (:meth:`TransformerStack._fc`), the
unfused attention's two ``matmul``s and ``flash_attention`` (in
:meth:`TransformerStack._block`) and ``fused_ffn_tail`` (in
:meth:`TransformerStack._post_attention`).
"""
import collections

import numpy as np
import torch
from torch import nn

from .. import layers
from ..param_attr import ParamAttr
from ..ops.attention_ops import flash_attention
from ..ops.ce_ops import fused_softmax_ce
from ..ops.embedding_ops import embedding_gather
from ..ops.ffn_ops import fused_ffn_amp, fused_ffn_core
from ..ops.math_ops import matmul, mul
from ..ops.kv_cache_ops import (kv_cache_prefill, kv_cache_prefill_paged,
                                kv_cache_update, kv_cache_update_paged,
                                kv_cache_update_span_paged,
                                kv_decode_attention,
                                kv_decode_attention_paged,
                                kv_prefix_attention,
                                kv_verify_attention_paged, sample_next_token)
from ..ops.nn_ops import fused_ln_residual, layer_norm
from ..ops.random_ops import dropout, keep_mask
from ..ops.tensor_ops import add_position_encoding, position_encoding_table

__all__ = ['LMConfig', 'build_lm', 'multi_head_attention',
           'transformer_block', 'TransformerLM', 'TransformerStack',
           'param_shapes', 'block_param_shapes', 'init_params',
           'KV_CACHE_K', 'KV_CACHE_V', 'SAMPLE_FEEDS',
           'build_lm_decode_step', 'build_lm_drafter', 'build_lm_verify',
           'build_lm_prefill', 'build_lm_prefill_paged']


class LMConfig(object):
    """The LM's shape: the JAX package's `LMConfig` fields and defaults
    (the flagship: V 32000, d 512, 8 heads, 6 layers, d_ff 2048)."""

    def __init__(self, vocab_size=32000, seq_len=512, d_model=512,
                 n_head=8, n_layer=6, d_ff=2048, dropout=0.1,
                 attn_dropout=None, use_flash_attention=True):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.d_model = d_model
        self.n_head = n_head
        self.n_layer = n_layer
        self.d_ff = d_ff
        self.dropout = dropout
        self.attn_dropout = dropout if attn_dropout is None else attn_dropout
        self.use_flash_attention = use_flash_attention


def block_param_shapes(shapes, cfg, prefix):
    """Add one block's parameters, named ``prefix + '.ln1.w'`` ..., to
    ``shapes`` in the JAX package's creation order."""
    d, f, p = cfg.d_model, cfg.d_ff, prefix
    shapes[p + '.ln1.w'] = (d,)
    shapes[p + '.ln1.b'] = (d,)
    shapes[p + '.attn.qkv.w'] = (d, 3 * d)
    shapes[p + '.attn.qkv.b'] = (3 * d,)
    shapes[p + '.attn.proj.w'] = (d, d)
    shapes[p + '.attn.proj.b'] = (d,)
    shapes[p + '.ln2.w'] = (d,)
    shapes[p + '.ln2.b'] = (d,)
    shapes[p + '.ffn1.w'] = (d, f)
    shapes[p + '.ffn1.b'] = (f,)
    shapes[p + '.ffn2.w'] = (f, d)
    shapes[p + '.ffn2.b'] = (d,)


def param_shapes(cfg):
    """{JAX parameter name: shape}, in the JAX package's creation order."""
    d, V = cfg.d_model, cfg.vocab_size
    shapes = collections.OrderedDict()
    shapes['tok_emb.w'] = (V, d)
    for i in range(cfg.n_layer):
        block_param_shapes(shapes, cfg, 'layer_%d' % i)
    shapes['final_ln.w'] = (d,)
    shapes['final_ln.b'] = (d,)
    shapes['lm_head.w'] = (d, V)
    return shapes


def init_params(cfg, seed, device, shapes=None):
    """Fresh parameters from ``seed`` (a torch.Generator on the CPU):
    N(0, 0.02) weights, unit LayerNorm scales, zero biases. These are not
    the JAX package's initial values. ``shapes`` is the {name: shape} map
    to fill, the LM's `param_shapes(cfg)` when None."""
    g = torch.Generator(device='cpu').manual_seed(int(seed))
    out = collections.OrderedDict()
    for name, shape in (shapes or param_shapes(cfg)).items():
        if name.endswith('.b'):
            t = torch.zeros(shape)
        elif len(shape) == 1:
            t = torch.ones(shape)
        else:
            t = torch.randn(shape, generator=g) * 0.02
        out[name] = t.to(device)
    return out


# ---------------------------------------------------------------------------
# the program builder (paddle_tpu/models/transformer.py:44-235)


def multi_head_attention(x, cfg, prefix, mask_var=None, is_test=False,
                         seq_parallel=False, causal=False,
                         key_padding_bias=None):
    """Fused-QKV multi-head self-attention: one (D, 3D) product for Q, K
    and V, then the ``flash_attention`` op (causal or with a key-padding
    bias, no full mask, no live attention dropout) or the unfused matmul,
    mask, softmax, dropout, matmul."""
    d, h = cfg.d_model, cfg.n_head
    dh = d // h
    qkv = layers.fc(input=x, size=3 * d, num_flatten_dims=2,
                    param_attr=ParamAttr(name=prefix + '.qkv.w'),
                    bias_attr=ParamAttr(name=prefix + '.qkv.b'))
    qkv = layers.reshape(qkv, shape=[0, cfg.seq_len, 3, h, dh])
    qkv = layers.transpose(qkv, perm=[2, 0, 3, 1, 4])  # (3, B, H, L, dh)
    q = layers.squeeze(layers.slice(qkv, axes=[0], starts=[0], ends=[1]),
                       axes=[0])
    k = layers.squeeze(layers.slice(qkv, axes=[0], starts=[1], ends=[2]),
                       axes=[0])
    v = layers.squeeze(layers.slice(qkv, axes=[0], starts=[2], ends=[3]),
                       axes=[0])
    attn_drop = getattr(cfg, 'attn_dropout', 0.0)
    use_flash = getattr(cfg, 'use_flash_attention', False) and \
        (causal or key_padding_bias is not None) and \
        mask_var is None and (is_test or not attn_drop)
    if use_flash:
        helper_block = x.block
        ctx = helper_block.create_var(
            name=prefix + '.flash_out',
            shape=(-1, h, cfg.seq_len, dh), dtype='float32')
        flash_inputs = {'Q': [q], 'K': [k], 'V': [v]}
        if key_padding_bias is not None:
            flash_inputs['KeyPaddingBias'] = [key_padding_bias]
        helper_block.append_op(
            type='flash_attention',
            inputs=flash_inputs,
            outputs={'Out': [ctx]},
            attrs={'scale': dh ** -0.5, 'causal': bool(causal),
                   'ring_zigzag': bool(getattr(cfg, 'ring_zigzag',
                                               False))})
    else:
        logits = layers.matmul(q, k, transpose_y=True, alpha=dh ** -0.5)
        if mask_var is not None:
            logits = layers.elementwise_add(logits, mask_var)
        if key_padding_bias is not None:
            logits = layers.elementwise_add(
                logits, layers.reshape(key_padding_bias,
                                       [-1, 1, 1, cfg.seq_len]))
        weights = layers.softmax(logits)
        if attn_drop and not is_test:
            weights = layers.dropout(weights, dropout_prob=attn_drop,
                                     is_test=is_test,
                                     dropout_implementation='upscale_in_train')
        ctx = layers.matmul(weights, v)                # (B, H, L, dh)
    ctx = layers.transpose(ctx, perm=[0, 2, 1, 3])
    ctx = layers.reshape(ctx, shape=[0, cfg.seq_len, d])
    out = layers.fc(input=ctx, size=d, num_flatten_dims=2,
                    param_attr=ParamAttr(name=prefix + '.proj.w'),
                    bias_attr=ParamAttr(name=prefix + '.proj.b'))
    return out


def _entry_ln(x, residual, bna, name):
    """LayerNorm at a residual-stream read point, fused with the pending
    FFN delta ``residual`` when there is one. Returns (ln_out, stream)."""
    if residual is None:
        ln = layers.layer_norm(x, begin_norm_axis=bna,
                               param_attr=ParamAttr(name=name + '.w'),
                               bias_attr=ParamAttr(name=name + '.b'))
        return ln, x
    return layers.fused_layer_norm_residual(
        x, residual, begin_norm_axis=bna,
        param_attr=ParamAttr(name=name + '.w'),
        bias_attr=ParamAttr(name=name + '.b'))


def _ffn_tail(ln2, cfg, prefix, num_flatten_dims, dropout_prob=0.0,
              is_test=True):
    """The block's FFN tail as ONE fused_ffn_tail op."""
    return layers.fused_ffn_tail(
        ln2, cfg.d_ff, cfg.d_model,
        num_flatten_dims=num_flatten_dims,
        dropout_prob=dropout_prob, is_test=is_test,
        inner_param_attr=ParamAttr(name=prefix + '.ffn1.w'),
        inner_bias_attr=ParamAttr(name=prefix + '.ffn1.b'),
        param_attr=ParamAttr(name=prefix + '.ffn2.w'),
        bias_attr=ParamAttr(name=prefix + '.ffn2.b'))


def transformer_block(x, cfg, prefix, mask_var=None, is_test=False,
                      causal=False, key_padding_bias=None, residual=None,
                      defer_residual=False):
    """Pre-norm residual block. ``residual`` is the previous block's
    unadded FFN delta (fused into the entry LayerNorm);
    ``defer_residual=True`` returns ``(stream, delta)`` with this block's
    FFN output unadded."""
    ln1, x = _entry_ln(x, residual, 2, prefix + '.ln1')
    attn = multi_head_attention(ln1, cfg, prefix + '.attn',
                                mask_var=mask_var, is_test=is_test,
                                causal=causal,
                                key_padding_bias=key_padding_bias)
    ln2, x = layers.fused_layer_norm_residual(
        x, attn, begin_norm_axis=2,
        param_attr=ParamAttr(name=prefix + '.ln2.w'),
        bias_attr=ParamAttr(name=prefix + '.ln2.b'))
    ff2 = _ffn_tail(ln2, cfg, prefix, 2,
                    dropout_prob=float(cfg.dropout or 0.0),
                    is_test=is_test)
    if defer_residual:
        return x, ff2
    return layers.elementwise_add(x, ff2)


def build_lm(cfg=None, is_test=False):
    """Causal LM into the default programs: feeds {'tokens', 'labels'} of
    shape (B, L) int64; returns (tokens, labels, logits, avg_loss)."""
    cfg = cfg or LMConfig()
    tokens = layers.data(name='tokens', shape=[cfg.seq_len], dtype='int64')
    labels = layers.data(name='labels', shape=[cfg.seq_len], dtype='int64')

    emb = layers.embedding(
        tokens, size=[cfg.vocab_size, cfg.d_model], dtype='float32',
        param_attr=ParamAttr(name='tok_emb.w'))
    x = layers.add_position_encoding(emb, alpha=1.0, beta=1.0)
    if cfg.dropout and not is_test:
        x = layers.dropout(x, dropout_prob=cfg.dropout, is_test=is_test,
                           dropout_implementation='upscale_in_train')

    attn_drop = getattr(cfg, 'attn_dropout', 0.0)
    flash_ok = getattr(cfg, 'use_flash_attention', False) and \
        (is_test or not attn_drop)
    if flash_ok:
        mask_var = None          # causal masking fused into the kernel
    else:
        causal_mask = np.triu(np.full((cfg.seq_len, cfg.seq_len), -1e9,
                                      dtype='float32'), k=1)
        mask_var = layers.assign(causal_mask)

    block_outputs = []
    # a zero delta ahead of block 0: every block's entry LN is a fused site
    delta = layers.scale(x, scale=0.0)
    for i in range(cfg.n_layer):
        x, delta = transformer_block(x, cfg, 'layer_%d' % i,
                                     mask_var=mask_var, is_test=is_test,
                                     causal=flash_ok, residual=delta,
                                     defer_residual=True)
        block_outputs.append(x)
    # the JAX package's remat boundaries (rematerialization waits) and the
    # health observatory's activation taps, recorded on the program
    cfg.block_outputs = block_outputs
    tokens.block.program._lm_checkpoint_vars = block_outputs
    tokens.block.program._health_act_taps = tuple(
        v.name for v in block_outputs)
    x, _ = _entry_ln(x, delta, 2, 'final_ln')
    logits = layers.fc(input=x, size=cfg.vocab_size, num_flatten_dims=2,
                       param_attr=ParamAttr(name='lm_head.w'),
                       bias_attr=False)
    flat_logits = layers.reshape(logits, shape=[-1, cfg.vocab_size])
    flat_labels = layers.reshape(labels, shape=[-1, 1])
    loss = layers.softmax_with_cross_entropy(flat_logits, flat_labels)
    avg_loss = layers.mean(loss)
    return tokens, labels, logits, avg_loss


# ---------------------------------------------------------------------------
# The decode programs: the JAX package's build functions
# (paddle_tpu/models/transformer.py:284-872), appending the same ops to
# the default programs.
# They bind with Executor.bind; each cache is a persistable variable the
# scope holds (zeros, as the JAX engine sets them up) and the write ops
# update in place (ops/kv_cache_ops.py). The module's TransformerLM runs
# the same towers without a Program (serving/generate.py).
# ---------------------------------------------------------------------------

KV_CACHE_K = 'gen_kv_k'
KV_CACHE_V = 'gen_kv_v'


def _declare_kv_caches(block, cfg, slots, max_len):
    dh = cfg.d_model // cfg.n_head
    shape = (slots, cfg.n_layer, cfg.n_head, max_len, dh)
    kc = block.create_var(name=KV_CACHE_K, shape=shape, dtype='float32',
                          persistable=True, stop_gradient=True)
    vc = block.create_var(name=KV_CACHE_V, shape=shape, dtype='float32',
                          persistable=True, stop_gradient=True)
    return kc, vc


def _declare_paged_kv_caches(block, cfg, num_blocks, block_size):
    dh = cfg.d_model // cfg.n_head
    shape = (num_blocks, cfg.n_layer, cfg.n_head, block_size, dh)
    kc = block.create_var(name=KV_CACHE_K, shape=shape, dtype='float32',
                          persistable=True, stop_gradient=True)
    vc = block.create_var(name=KV_CACHE_V, shape=shape, dtype='float32',
                          persistable=True, stop_gradient=True)
    return kc, vc


SAMPLE_FEEDS = ('gen_temp', 'gen_topk', 'gen_topp', 'gen_u')


def _sampling_inputs():
    """Per-row sampling-control feeds ([rows, 1]; [1, 1] in prefill):
    temperature, top-k, top-p, and the host-drawn uniform."""
    temp = layers.data(name='gen_temp', shape=[1], dtype='float32')
    topk = layers.data(name='gen_topk', shape=[1], dtype='int64')
    topp = layers.data(name='gen_topp', shape=[1], dtype='float32')
    u = layers.data(name='gen_u', shape=[1], dtype='float32')
    return temp, topk, topp, u


def _append_sample_op(block, logits, sample_vars, out_name):
    temp, topk, topp, u = sample_vars
    out = block.create_var(name=out_name, shape=(-1,), dtype='int64')
    block.append_op(
        type='sample_next_token',
        inputs={'Logits': [logits], 'Temp': [temp], 'TopK': [topk],
                'TopP': [topp], 'U': [u]},
        outputs={'Out': [out]})
    return out


def _cache_write(block, op_type, cache, new, index_var, layer):
    """Append a cache-write op whose output IS the cache var (read-modify-
    write persistable state: the lowering writes the scope's tensor in
    place and binds it back, ops/kv_cache_ops.py)."""
    index_slot = 'Slot' if op_type == 'kv_cache_prefill' else 'Positions'
    block.append_op(
        type=op_type,
        inputs={'Cache': [cache], 'New': [new], index_slot: [index_var]},
        outputs={'Out': [cache]},
        attrs={'layer': int(layer)})
    return cache


def _qkv_split_step(qkv, cfg):
    """[S, 3d] -> three [S, H, dh], with the same 3/h/dh unpacking order as
    build_lm's reshape (q first, then k, then v)."""
    h, dh = cfg.n_head, cfg.d_model // cfg.n_head
    qkv = layers.reshape(qkv, shape=[-1, 3, h, dh])
    parts = []
    for i in range(3):
        parts.append(layers.squeeze(
            layers.slice(qkv, axes=[1], starts=[i], ends=[i + 1]),
            axes=[1]))
    return parts


def _decode_tower(cfg, x, cache_write, attend, tag='', head=True):
    """One decode-position transformer tower over per-slot row state
    ``x`` ([S, d]: token embedding + position encoding). The cache
    write and cached attention are delegated to closures so the SAME
    structural body serves the plain decode step, each of the drafter's
    unrolled steps, and any future cached-decode flavor — per-position
    numerics can never drift between them. Returns logits [S, V].

    ``tag`` disambiguates intermediate var names when the tower is
    instantiated more than once in one program (the drafter's unroll).
    ``head=False`` skips the final LayerNorm + LM head and returns
    None — the drafter's trailing write-only step needs every layer's
    K/V deposited but no logits."""
    d, h = cfg.d_model, cfg.n_head
    dh = d // h
    delta = None             # previous layer's deferred FFN output
    for i in range(cfg.n_layer):
        p = 'layer_%d' % i
        ln1, x = _entry_ln(x, delta, 1, p + '.ln1')
        qkv = layers.fc(ln1, size=3 * d,
                        param_attr=ParamAttr(name=p + '.attn.qkv.w'),
                        bias_attr=ParamAttr(name=p + '.attn.qkv.b'))
        q, k, v = _qkv_split_step(qkv, cfg)                  # [S, H, dh]
        cache_write(k, v, i)
        if not head and i == cfg.n_layer - 1:
            # write-only tower, last layer: nothing consumes x past
            # this K/V deposit — attention/proj/ffn are dead compute
            return None
        ctx = attend(q, i, p + tag)
        attn = layers.fc(layers.reshape(ctx, shape=[-1, d]), size=d,
                         param_attr=ParamAttr(name=p + '.attn.proj.w'),
                         bias_attr=ParamAttr(name=p + '.attn.proj.b'))
        ln2, x = layers.fused_layer_norm_residual(
            x, attn, begin_norm_axis=1,
            param_attr=ParamAttr(name=p + '.ln2.w'),
            bias_attr=ParamAttr(name=p + '.ln2.b'))
        # decode is inference-only: prob 0 / is_test keeps the op on the
        # RNG-free bind fast path (no per-step key derivation)
        delta = _ffn_tail(ln2, cfg, p, 1)

    if not head:
        return None
    x, _ = _entry_ln(x, delta, 1, 'final_ln')
    return layers.fc(x, size=cfg.vocab_size,
                     param_attr=ParamAttr(name='lm_head.w'),
                     bias_attr=False)                        # [S, V]


def build_lm_decode_step(cfg, slots, max_len, block_size=None,
                         num_blocks=None):
    """Single-token decode step over ALL cache slots.

    Feeds: 'gen_tokens' [slots, 1] int64 (each slot's last token),
    'gen_pos' [slots, 1] int64 (the position each slot writes this step),
    the `SAMPLE_FEEDS` quad [slots, 1] (temperature / top-k / top-p /
    host uniform; all-zero = bitwise greedy), and — paged mode —
    'gen_btab' [slots, max_len // block_size] int64 per-slot block
    tables. Returns {'tokens', 'pos', 'logits', 'next_tokens',
    'k_cache', 'v_cache'} — fetch 'next_tokens' ([slots] int64)."""
    paged = block_size is not None
    d, h = cfg.d_model, cfg.n_head
    dh = d // h
    tokens = layers.data(name='gen_tokens', shape=[1], dtype='int64')
    pos = layers.data(name='gen_pos', shape=[1], dtype='int64')
    sample_vars = _sampling_inputs()
    block = tokens.block
    if paged:
        mb = max_len // block_size
        btab = layers.data(name='gen_btab', shape=[mb], dtype='int64')
        kc, vc = _declare_paged_kv_caches(block, cfg, num_blocks,
                                          block_size)
    else:
        kc, vc = _declare_kv_caches(block, cfg, slots, max_len)

    x = layers.embedding(
        tokens, size=[cfg.vocab_size, d], dtype='float32',
        param_attr=ParamAttr(name='tok_emb.w'))              # [S, d]
    pe = layers.assign(position_encoding_table(max_len, d))
    x = layers.elementwise_add(x, layers.gather(pe, pos))

    def cache_write(k, v, layer):
        for cache, new in ((kc, k), (vc, v)):
            if not paged:
                _cache_write(block, 'kv_cache_update', cache, new,
                             pos, layer)
                continue
            block.append_op(
                type='kv_cache_update_paged',
                inputs={'Cache': [cache], 'New': [new],
                        'Positions': [pos], 'BlockTables': [btab]},
                outputs={'Out': [cache]},
                attrs={'layer': int(layer),
                       'block_size': int(block_size)})

    def attend(q, layer, name):
        ctx = block.create_var(name=name + '.kv_ctx',
                               shape=(-1, h, dh), dtype='float32')
        attn_inputs = {'Q': [q], 'KCache': [kc], 'VCache': [vc],
                       'Positions': [pos]}
        attn_attrs = {'layer': layer, 'scale': dh ** -0.5}
        if paged:
            attn_inputs['BlockTables'] = [btab]
            attn_attrs['block_size'] = int(block_size)
        block.append_op(
            type='kv_decode_attention_paged' if paged
            else 'kv_decode_attention',
            inputs=attn_inputs,
            outputs={'Out': [ctx]},
            attrs=attn_attrs)
        return ctx

    logits = _decode_tower(cfg, x, cache_write, attend)      # [S, V]
    next_tokens = _append_sample_op(block, logits, sample_vars,
                                    'gen_next_tokens')       # [S]
    return {'tokens': tokens, 'pos': pos, 'logits': logits,
            'next_tokens': next_tokens, 'k_cache': kc, 'v_cache': vc}


def build_lm_drafter(cfg, slots, max_len, spec_k, num_blocks, block_size):
    """``spec_k`` greedy decode steps UNROLLED into one program — the
    draft leg of speculative decoding. Each unrolled step is the
    same `_decode_tower` as the plain decode step, its argmax feeding
    the next step's embedding IN-PROGRAM, so the K draft proposals cost
    one host dispatch instead of K (the chip never waits on the host
    between draft tokens).

    Feeds: 'gen_tokens' [slots, 1] int64 (each slot's last accepted
    token), 'gen_pos' [slots, 1] int64 (the position draft step 0
    writes; step j writes pos + j), 'gen_btab'
    [slots, max_len // block_size] int64 per-slot DRAFT block tables,
    and 'gen_vmask' [slots, spec_k + 1] int64 (nonzero = step j's write
    is budgeted; zero rows — idle slots, positions at or past max_len —
    redirect to the trash block). Returns {'tokens', 'pos',
    'block_table', 'vmask', 'draft_tokens' (list of spec_k [slots]
    int64 vars), 'k_cache', 'v_cache'}.

    The unroll is spec_k + 1 towers: the trailing step is WRITE-ONLY
    (``head=False`` — no logits), depositing the K-th draft token's own
    K/V at position pos + spec_k. Without it, a fully-accepted round
    (spec_k drafts + the target's bonus token) would leave a hole in
    the draft cache at the bonus position and every later draft would
    attend garbage there — the accept rate of a target-equal draft
    would silently drop from 1.0.

    Drafting is greedy by construction (argmax — the same argmax the
    sample op's temperature-0 branch takes): a draft
    is a PROPOSAL, the target's verify step decides every emitted
    token, so draft sampling would only lower the accept rate."""
    d, h = cfg.d_model, cfg.n_head
    dh = d // h
    mb = max_len // block_size
    tokens = layers.data(name='gen_tokens', shape=[1], dtype='int64')
    pos = layers.data(name='gen_pos', shape=[1], dtype='int64')
    btab = layers.data(name='gen_btab', shape=[mb], dtype='int64')
    vmask = layers.data(name='gen_vmask', shape=[spec_k + 1],
                        dtype='int64')
    block = tokens.block
    kc, vc = _declare_paged_kv_caches(block, cfg, num_blocks, block_size)
    pe = layers.assign(position_encoding_table(max_len, d))

    drafts = []
    tok = tokens                                 # [S, 1] feed; then [S]
    for j in range(spec_k + 1):
        if j == 0:
            pos_j = pos
        else:
            pos_j = layers.elementwise_add(
                pos, layers.fill_constant(shape=[1], dtype='int64',
                                          value=j))
        valid_j = layers.slice(vmask, axes=[1], starts=[j], ends=[j + 1])
        x = layers.embedding(
            tok, size=[cfg.vocab_size, d], dtype='float32',
            param_attr=ParamAttr(name='tok_emb.w'))          # [S, d]
        # a capped slot's pos >= max_len gathers a row of the fill value
        # (tensor_ops.gather, jnp.take's mode) — its output is garbage the
        # host never accepts, and its cache write is vmask-trashed
        x = layers.elementwise_add(x, layers.gather(pe, pos_j))

        def cache_write(k, v, layer, _pos=pos_j, _valid=valid_j):
            for cache, new in ((kc, k), (vc, v)):
                block.append_op(
                    type='kv_cache_update_paged',
                    inputs={'Cache': [cache], 'New': [new],
                            'Positions': [_pos], 'BlockTables': [btab],
                            'Valid': [_valid]},
                    outputs={'Out': [cache]},
                    attrs={'layer': int(layer),
                           'block_size': int(block_size)})

        def attend(q, layer, name, _pos=pos_j):
            ctx = block.create_var(name=name + '.kv_ctx',
                                   shape=(-1, h, dh), dtype='float32')
            block.append_op(
                type='kv_decode_attention_paged',
                inputs={'Q': [q], 'KCache': [kc], 'VCache': [vc],
                        'Positions': [_pos], 'BlockTables': [btab]},
                outputs={'Out': [ctx]},
                attrs={'layer': layer, 'scale': dh ** -0.5,
                       'block_size': int(block_size)})
            return ctx

        logits = _decode_tower(cfg, x, cache_write, attend,
                               tag='.draft%d' % j,
                               head=j < spec_k)              # [S, V]
        if j < spec_k:
            tok = layers.argmax(logits, axis=1)              # [S] int64
            drafts.append(tok)
    # ONE [S, spec_k] fetch: K separate fetches would cost K host
    # syncs per round
    cat = layers.concat([layers.reshape(t, shape=[-1, 1])
                         for t in drafts], axis=1)
    return {'tokens': tokens, 'pos': pos, 'block_table': btab,
            'vmask': vmask, 'draft_tokens': cat,
            'k_cache': kc, 'v_cache': vc}


def build_lm_verify(cfg, slots, width, max_len, num_blocks, block_size):
    """Target-model VERIFY step: score ``width = spec_k + 1`` positions
    of every slot in ONE batched dispatch — the wide sibling of the
    decode step that converts K sequential target steps into one.

    Row t of slot s carries the token at global position
    ``gen_pos[s, t]`` (row 0 = the slot's last accepted token, rows
    1..K = the draft proposals). Every row's K/V is deposited through
    the slot's block table first (`kv_cache_update_span_paged`,
    vmask-guarded), then each row attends the cached history plus the
    window rows at or before it (`kv_verify_attention_paged`) — so row
    t's logits are IDENTICAL to what the plain decode step would have
    produced at that position, and the greedy argmax over them is the
    bitwise acceptance oracle: tokens are emitted exactly as
    non-speculative greedy decode would have emitted them, speculation
    only changes how many land per dispatch.

    The program IS the decode tower: the (slot, window-row) pairs
    flatten onto the tower's row axis ([slots * width, d]) and run the
    SAME `_decode_tower` body as the plain decode step and the drafter
    — only the cache write (span variant) and attention (per-row
    position masks) closures differ, so the acceptance oracle can
    never numerically drift from the step program it stands in for.

    Feeds: 'gen_tokens' [slots, width] int64, 'gen_pos' [slots, width]
    int64 (host-clipped to max_len - 1), 'gen_btab'
    [slots, max_len // block_size] int64, 'gen_vmask' [slots, width]
    int64. Returns {'tokens', 'pos', 'block_table', 'vmask', 'logits'
    ([slots * width, vocab], row-major), 'verify_tokens'
    ([slots * width] int64, row-major), 'k_cache', 'v_cache'}."""
    d, h = cfg.d_model, cfg.n_head
    dh = d // h
    W = int(width)
    if W < 2:
        raise ValueError("verify width must be >= 2 (spec_k >= 1), "
                         "got %d" % W)
    mb = max_len // block_size
    tokens = layers.data(name='gen_tokens', shape=[W], dtype='int64')
    pos = layers.data(name='gen_pos', shape=[W], dtype='int64')
    btab = layers.data(name='gen_btab', shape=[mb], dtype='int64')
    vmask = layers.data(name='gen_vmask', shape=[W], dtype='int64')
    block = tokens.block
    kc, vc = _declare_paged_kv_caches(block, cfg, num_blocks, block_size)

    flat = layers.reshape(tokens, shape=[-1])                # [S*W]
    x = layers.embedding(
        flat, size=[cfg.vocab_size, d], dtype='float32',
        param_attr=ParamAttr(name='tok_emb.w'))              # [S*W, d]
    pe = layers.assign(position_encoding_table(max_len, d))
    x = layers.elementwise_add(x, layers.gather(pe, pos))

    def cache_write(k, v, layer):
        # tower rows [S*W, H, dh] -> the span op's [S, H, W, dh]
        for cache, new in ((kc, k), (vc, v)):
            rows = layers.transpose(
                layers.reshape(new, shape=[-1, W, h, dh]),
                perm=[0, 2, 1, 3])
            block.append_op(
                type='kv_cache_update_span_paged',
                inputs={'Cache': [cache], 'New': [rows],
                        'Positions': [pos], 'BlockTables': [btab],
                        'Valid': [vmask]},
                outputs={'Out': [cache]},
                attrs={'layer': int(layer),
                       'block_size': int(block_size)})

    def attend(q, layer, name):
        qw = layers.transpose(layers.reshape(q, shape=[-1, W, h, dh]),
                              perm=[0, 2, 1, 3])             # [S,H,W,dh]
        ctx = block.create_var(name=name + '.verify_attn_out',
                               shape=(-1, h, W, dh), dtype='float32')
        block.append_op(
            type='kv_verify_attention_paged',
            inputs={'Q': [qw], 'KCache': [kc], 'VCache': [vc],
                    'Positions': [pos], 'BlockTables': [btab]},
            outputs={'Out': [ctx]},
            attrs={'layer': layer, 'scale': dh ** -0.5,
                   'block_size': int(block_size)})
        # [S, W, H, dh]: the tower's reshape([-1, d]) then folds the
        # heads back into row order (s, w)
        return layers.transpose(ctx, perm=[0, 2, 1, 3])

    logits = _decode_tower(cfg, x, cache_write, attend,
                           tag='.verify')                    # [S*W, V]
    # the same argmax the sample op's temperature-0 branch takes —
    # greedy acceptance is bitwise against the plain decode step
    nxt = layers.argmax(logits, axis=1)                      # [S*W]
    return {'tokens': tokens, 'pos': pos, 'block_table': btab,
            'vmask': vmask, 'logits': logits, 'verify_tokens': nxt,
            'k_cache': kc, 'v_cache': vc}


def build_lm_prefill(cfg, prompt_len, slots, max_len):
    """Prefill ONE prompt (padded to `prompt_len`, a bucket cell) into one
    cache slot and emit the first generated token.

    Feeds: 'gen_prompt' [1, prompt_len] int64, 'gen_slot' [1, 1] int64,
    'gen_len' [1, 1] int64 (real prompt length; pad rows beyond it are
    causal-masked out of the answer and overwritten by later decode
    steps). Returns {'prompt', 'slot', 'length', 'logits', 'first_token',
    'k_cache', 'v_cache'} — fetch 'first_token' ([1] int64)."""
    if prompt_len > max_len:
        raise ValueError(
            "prompt bucket %d exceeds the KV cache width max_len=%d"
            % (prompt_len, max_len))
    d, h = cfg.d_model, cfg.n_head
    dh = d // h
    T = int(prompt_len)
    prompt = layers.data(name='gen_prompt', shape=[-1, T], dtype='int64')
    slot = layers.data(name='gen_slot', shape=[1], dtype='int64')
    length = layers.data(name='gen_len', shape=[1], dtype='int64')
    sample_vars = _sampling_inputs()
    block = prompt.block
    kc, vc = _declare_kv_caches(block, cfg, slots, max_len)

    emb = layers.embedding(
        prompt, size=[cfg.vocab_size, d], dtype='float32',
        param_attr=ParamAttr(name='tok_emb.w'))              # [1, T, d]
    x = layers.add_position_encoding(emb, alpha=1.0, beta=1.0)

    use_flash = bool(getattr(cfg, 'use_flash_attention', False))
    mask_var = None
    if not use_flash:
        causal_mask = np.triu(np.full((T, T), -1e9, dtype='float32'), k=1)
        mask_var = layers.assign(causal_mask)

    delta = None
    for i in range(cfg.n_layer):
        p = 'layer_%d' % i
        ln1, x = _entry_ln(x, delta, 2, p + '.ln1')
        qkv = layers.fc(ln1, size=3 * d, num_flatten_dims=2,
                        param_attr=ParamAttr(name=p + '.attn.qkv.w'),
                        bias_attr=ParamAttr(name=p + '.attn.qkv.b'))
        qkv = layers.reshape(qkv, shape=[0, T, 3, h, dh])
        qkv = layers.transpose(qkv, perm=[2, 0, 3, 1, 4])    # (3,1,H,T,dh)
        q = layers.squeeze(layers.slice(qkv, axes=[0], starts=[0],
                                        ends=[1]), axes=[0])
        k = layers.squeeze(layers.slice(qkv, axes=[0], starts=[1],
                                        ends=[2]), axes=[0])
        v = layers.squeeze(layers.slice(qkv, axes=[0], starts=[2],
                                        ends=[3]), axes=[0])
        kc = _cache_write(block, 'kv_cache_prefill', kc, k, slot, i)
        vc = _cache_write(block, 'kv_cache_prefill', vc, v, slot, i)
        if use_flash:
            ctx = block.create_var(name=p + '.prefill_flash_out',
                                   shape=(-1, h, T, dh), dtype='float32')
            block.append_op(
                type='flash_attention',
                inputs={'Q': [q], 'K': [k], 'V': [v]},
                outputs={'Out': [ctx]},
                attrs={'scale': dh ** -0.5, 'causal': True,
                       'ring_zigzag': False})
        else:
            logits_a = layers.matmul(q, k, transpose_y=True,
                                     alpha=dh ** -0.5)
            logits_a = layers.elementwise_add(logits_a, mask_var)
            weights = layers.softmax(logits_a)
            ctx = layers.matmul(weights, v)                  # (1,H,T,dh)
        ctx = layers.transpose(ctx, perm=[0, 2, 1, 3])
        ctx = layers.reshape(ctx, shape=[0, T, d])
        attn = layers.fc(ctx, size=d, num_flatten_dims=2,
                         param_attr=ParamAttr(name=p + '.attn.proj.w'),
                         bias_attr=ParamAttr(name=p + '.attn.proj.b'))
        ln2, x = layers.fused_layer_norm_residual(
            x, attn, begin_norm_axis=2,
            param_attr=ParamAttr(name=p + '.ln2.w'),
            bias_attr=ParamAttr(name=p + '.ln2.b'))
        delta = _ffn_tail(ln2, cfg, p, 2)

    x, _ = _entry_ln(x, delta, 2, 'final_ln')
    # only the last REAL row feeds the LM head: one [1, d] x [d, V] matmul
    # instead of projecting all T rows to vocab
    x_flat = layers.reshape(x, shape=[-1, d])                # [T, d]
    one = layers.fill_constant(shape=[1], dtype='int64', value=1)
    last = layers.gather(x_flat, layers.elementwise_sub(length, one))
    logits = layers.fc(last, size=cfg.vocab_size,
                       param_attr=ParamAttr(name='lm_head.w'),
                       bias_attr=False)                      # [1, V]
    first_token = _append_sample_op(block, logits, sample_vars,
                                    'gen_first_token')       # [1]
    return {'prompt': prompt, 'slot': slot, 'length': length,
            'logits': logits, 'first_token': first_token,
            'k_cache': kc, 'v_cache': vc}


def build_lm_prefill_paged(cfg, prompt_len, num_blocks, block_size,
                           max_blocks):
    """Prefill one prompt SUFFIX (padded to the `prompt_len` bucket) into
    a paged cache slot and emit the first generated token.

    The suffix's query row t sits at global position ctx_len + t: with a
    shared prefix of ctx_len tokens already cached in the slot's leading
    block-table entries, only the suffix is embedded, projected and
    written — the prefix K/V are READ by `kv_prefix_attention`, never
    recomputed, which is exactly the prefill-compute saving prefix
    sharing promises. ctx_len = 0 degenerates to the ordinary causal
    prefill (computed against the cache instead of a local K/V copy).

    Feeds: 'gen_prompt' [1, prompt_len] int64 (suffix tokens),
    'gen_pos' [1, prompt_len] int64 (global positions ctx_len + t,
    host-precomputed), 'gen_btab' [1, max_blocks] int64 (the slot's
    block table), 'gen_len' [1, 1] int64 (REAL suffix length; pad rows
    write to the trash block), and the `SAMPLE_FEEDS` quad [1, 1].
    Returns {'prompt', 'positions', 'block_table', 'length', 'logits',
    'first_token', 'k_cache', 'v_cache'}."""
    d, h = cfg.d_model, cfg.n_head
    dh = d // h
    T = int(prompt_len)
    prompt = layers.data(name='gen_prompt', shape=[-1, T], dtype='int64')
    pos = layers.data(name='gen_pos', shape=[-1, T], dtype='int64')
    btab = layers.data(name='gen_btab', shape=[max_blocks], dtype='int64')
    length = layers.data(name='gen_len', shape=[1], dtype='int64')
    sample_vars = _sampling_inputs()
    block = prompt.block
    kc, vc = _declare_paged_kv_caches(block, cfg, num_blocks, block_size)

    emb = layers.embedding(
        prompt, size=[cfg.vocab_size, d], dtype='float32',
        param_attr=ParamAttr(name='tok_emb.w'))              # [1, T, d]
    # decode-parity positioning: gather the SAME sinusoid table rows the
    # contiguous prefill's add_position_encoding applies at offset 0
    pe = layers.assign(position_encoding_table(
        max_blocks * block_size, d))
    pe_rows = layers.reshape(layers.gather(pe, pos), shape=[-1, T, d])
    x = layers.elementwise_add(emb, pe_rows)

    def cache_write(cache, new, layer):
        block.append_op(
            type='kv_cache_prefill_paged',
            inputs={'Cache': [cache], 'New': [new], 'Positions': [pos],
                    'BlockTable': [btab], 'Length': [length]},
            outputs={'Out': [cache]},
            attrs={'layer': int(layer), 'block_size': int(block_size)})
        return cache

    delta = None
    for i in range(cfg.n_layer):
        p = 'layer_%d' % i
        ln1, x = _entry_ln(x, delta, 2, p + '.ln1')
        qkv = layers.fc(ln1, size=3 * d, num_flatten_dims=2,
                        param_attr=ParamAttr(name=p + '.attn.qkv.w'),
                        bias_attr=ParamAttr(name=p + '.attn.qkv.b'))
        qkv = layers.reshape(qkv, shape=[0, T, 3, h, dh])
        qkv = layers.transpose(qkv, perm=[2, 0, 3, 1, 4])    # (3,1,H,T,dh)
        q = layers.squeeze(layers.slice(qkv, axes=[0], starts=[0],
                                        ends=[1]), axes=[0])
        k = layers.squeeze(layers.slice(qkv, axes=[0], starts=[1],
                                        ends=[2]), axes=[0])
        v = layers.squeeze(layers.slice(qkv, axes=[0], starts=[2],
                                        ends=[3]), axes=[0])
        kc = cache_write(kc, k, i)
        vc = cache_write(vc, v, i)
        ctx = block.create_var(name=p + '.prefix_attn_out',
                               shape=(-1, h, T, dh), dtype='float32')
        block.append_op(
            type='kv_prefix_attention',
            inputs={'Q': [q], 'KCache': [kc], 'VCache': [vc],
                    'Positions': [pos], 'BlockTable': [btab]},
            outputs={'Out': [ctx]},
            attrs={'layer': i, 'scale': dh ** -0.5,
                   'block_size': int(block_size)})
        ctx = layers.transpose(ctx, perm=[0, 2, 1, 3])
        ctx = layers.reshape(ctx, shape=[0, T, d])
        attn = layers.fc(ctx, size=d, num_flatten_dims=2,
                         param_attr=ParamAttr(name=p + '.attn.proj.w'),
                         bias_attr=ParamAttr(name=p + '.attn.proj.b'))
        ln2, x = layers.fused_layer_norm_residual(
            x, attn, begin_norm_axis=2,
            param_attr=ParamAttr(name=p + '.ln2.w'),
            bias_attr=ParamAttr(name=p + '.ln2.b'))
        delta = _ffn_tail(ln2, cfg, p, 2)

    x, _ = _entry_ln(x, delta, 2, 'final_ln')
    x_flat = layers.reshape(x, shape=[-1, d])                # [T, d]
    one = layers.fill_constant(shape=[1], dtype='int64', value=1)
    last = layers.gather(x_flat, layers.elementwise_sub(length, one))
    logits = layers.fc(last, size=cfg.vocab_size,
                       param_attr=ParamAttr(name='lm_head.w'),
                       bias_attr=False)                      # [1, V]
    first_token = _append_sample_op(block, logits, sample_vars,
                                    'gen_first_token')       # [1]
    return {'prompt': prompt, 'positions': pos, 'block_table': btab,
            'length': length, 'logits': logits,
            'first_token': first_token, 'k_cache': kc, 'v_cache': vc}


def _key(name):
    # nn.Module parameter names cannot hold '.'
    return name.replace('.', '__')


class TransformerStack(nn.Module):
    """What the LM and BERT share: the parameters of ``shapes`` under their
    JAX names (``self.p``), the position table ``self.pe`` of ``max_len``
    rows, the pre-norm block of the training forward (:meth:`_block`) and
    the AMP marks of its sites (``self.amp``, {op type: dtype})."""

    # the op types of the JAX program's ops that the sites stand for
    SITE_TYPES = ('mul', 'matmul', 'flash_attention', 'fused_ffn_tail')

    def __init__(self, cfg, params, shapes, max_len):
        nn.Module.__init__(self)
        self.cfg = cfg
        self.max_len = int(max_len)
        self.weights = nn.ParameterDict()
        for name in shapes:
            self.weights[_key(name)] = nn.Parameter(params[name].detach())
        self.p = {name: self.weights[_key(name)] for name in shapes}
        self.register_buffer('pe', torch.from_numpy(
            position_encoding_table(self.max_len, cfg.d_model)).to(
                self.device))
        self.amp = {}

    def _block_sites(self, flash):
        """The op types of one block's sites, in the JAX program's order:
        qkv, the attention, proj, the FFN tail."""
        attn = ['flash_attention'] if flash else ['matmul', 'matmul']
        return ['mul'] + attn + ['mul', 'fused_ffn_tail']

    @property
    def device(self):
        return next(iter(self.p.values())).device

    def _fc(self, x, name, bias=True):
        y = mul(x, self.p[name + '.w'], self.amp.get('mul'))
        return y + self.p[name + '.b'] if bias else y

    def _entry_ln(self, x, delta, name):
        """LayerNorm at a residual-stream read point: fused with the
        pending FFN delta when there is one. Returns (ln_out, stream)."""
        w, b = self.p[name + '.w'], self.p[name + '.b']
        if delta is None:
            return layer_norm(x, w, b), x
        y, s, _, _ = fused_ln_residual(x, delta, w, b)
        return y, s

    def _post_attention(self, x, ctx, prefix, keep=None):
        """The block after its attention context ``ctx`` (shaped like the
        stream ``x``): proj, the fused residual-add + LayerNorm at ln2 and
        the FFN tail with its pre-scaled keep mask (rows x d_model, or
        None). Returns (stream, the FFN delta left unadded)."""
        d = x.shape[-1]
        attn = self._fc(ctx, prefix + '.attn.proj')
        ln2, x, _, _ = fused_ln_residual(x, attn, self.p[prefix + '.ln2.w'],
                                         self.p[prefix + '.ln2.b'])
        ffn = [ln2.reshape(-1, d)] + [self.p[prefix + n] for n in (
            '.ffn1.w', '.ffn1.b', '.ffn2.w', '.ffn2.b')]
        policy = self.amp.get('fused_ffn_tail')
        if policy:
            delta = fused_ffn_amp(*ffn, keep, policy=policy)
        else:
            delta, _ = fused_ffn_core(*ffn, keep)
        return x, delta.view(x.shape)

    def _unfused_attention(self, q, k, v, mask, attn_dropout=0.0,
                           generator=None):
        """The unfused branch of `multi_head_attention` over q, k, v [B, H,
        L, dh]: scores * dh^-0.5 + ``mask`` (broadcast to [B, H, L, L]),
        softmax, dropout on the weights, matmul with v."""
        policy = self.amp.get('matmul')
        scores = matmul(q, k.transpose(-1, -2), policy) * \
            q.shape[-1] ** -0.5 + mask
        weights = dropout(torch.softmax(scores, dim=-1), attn_dropout,
                          generator)
        return matmul(weights, v, policy)

    def _block(self, x, delta, prefix, causal, mask=None,
               key_padding_bias=None, dropout_prob=0.0, attn_dropout=0.0,
               generator=None):
        """One pre-norm block of a training forward over the stream ``x``
        [B, L, d] with the previous block's pending FFN ``delta``:
        the fused entry LayerNorm, QKV, attention, proj, the fused
        LayerNorm at ln2 and the FFN tail with its dropout mask. Attention
        is flash attention (``causal``, with ``key_padding_bias`` [B, L])
        when ``mask`` is None, as the models' ``flash_ok`` rule decides;
        else the unfused branch (:meth:`_unfused_attention`). Returns
        (stream, delta)."""
        B, L, d = x.shape
        h = self.cfg.n_head
        dh = d // h
        ln1, x = self._entry_ln(x, delta, prefix + '.ln1')
        qkv = self._fc(ln1, prefix + '.attn.qkv')
        q, k, v = qkv.view(B, L, 3, h, dh).permute(2, 0, 3, 1, 4)
        if mask is None:
            ctx = flash_attention(q, k, v, scale=dh ** -0.5, causal=causal,
                                  key_padding_bias=key_padding_bias,
                                  policy=self.amp.get('flash_attention'))
        else:
            ctx = self._unfused_attention(q, k, v, mask, attn_dropout,
                                          generator)
        ctx = ctx.permute(0, 2, 1, 3).reshape(B, L, d)
        keep = keep_mask((B * L, d), dropout_prob, generator, x.device) \
            if dropout_prob else None
        return self._post_attention(x, ctx, prefix, keep)


class TransformerLM(TransformerStack):
    """Decoder-only LM: :meth:`loss` is the training forward of `build_lm`;
    with a KV cache, :meth:`prefill` runs one prompt into a cache slot and
    :meth:`decode_step` advances every slot by one token (both under
    ``torch.no_grad``). With a paged cache, :meth:`prefill_paged` runs a
    prompt suffix into a slot's blocks and :meth:`decode_step` takes the
    slots' block tables; speculative decoding adds :meth:`draft_steps` and
    :meth:`verify_step` there. ``max_len`` bounds the positions: the
    position table has that many rows."""

    def __init__(self, cfg, params, max_len):
        TransformerStack.__init__(self, cfg, params, param_shapes(cfg),
                                  max_len)
        self.k_cache = None
        self.v_cache = None
        self.block_size = None
        # set by the decode engine once a CUDA graph holds the cache
        self.cache_captured = False

    def allocate_cache(self, slots):
        """Zeroed K and V caches [slots, layers, heads, max_len, dh]. Zeros,
        not empty memory: stale rows are masked by a select, but they must
        never hold uninitialised bits either. Raises once a CUDA graph has
        captured this model's cache (``cache_captured``): the graph holds
        the old addresses."""
        self._check_cache_free()
        c = self.cfg
        shape = (int(slots), c.n_layer, c.n_head, self.max_len,
                 c.d_model // c.n_head)
        self.k_cache = torch.zeros(shape, dtype=torch.float32,
                                   device=self.device)
        self.v_cache = torch.zeros_like(self.k_cache)
        self.block_size = None

    def allocate_paged_cache(self, num_blocks, block_size):
        """Zeroed K and V block pools [num_blocks, layers, heads,
        block_size, dh] (block 0 is the trash block), as
        :meth:`allocate_cache`."""
        self._check_cache_free()
        c = self.cfg
        shape = (int(num_blocks), c.n_layer, c.n_head, int(block_size),
                 c.d_model // c.n_head)
        self.k_cache = torch.zeros(shape, dtype=torch.float32,
                                   device=self.device)
        self.v_cache = torch.zeros_like(self.k_cache)
        self.block_size = int(block_size)

    def _check_cache_free(self):
        if self.cache_captured:
            raise RuntimeError(
                'a CUDA graph has captured this model\'s KV cache and holds '
                'its addresses: build a new model (or engine) for another '
                'cache')

    @staticmethod
    def _sample(logits, sample):
        if sample is None:
            return torch.argmax(logits, dim=1)
        temp, topk, topp, u, any_sampled = sample
        return sample_next_token(logits, temp, topk, topp, u,
                                 any_sampled=any_sampled)

    # -- entry points --------------------------------------------------------
    def flash_in_training(self):
        """`build_lm`'s ``flash_ok`` rule for a training forward: flash
        attention when it is on and attention dropout is 0, else the
        unfused matmul, mask, softmax, dropout, matmul."""
        return bool(self.cfg.use_flash_attention and
                    not self.cfg.attn_dropout)

    def forward_sites(self):
        """The op types of the AMP sites one training forward runs, in the
        order of `build_lm`'s ops: each block's, then lm_head's mul."""
        return self._block_sites(self.flash_in_training()) * \
            self.cfg.n_layer + ['mul']

    def logits(self, tokens, generator=None):
        """The [B * L, V] logits of `build_lm`'s training forward for tokens
        [B, L] (int64, L <= max_len): embedding gather + position encoding,
        dropout, a zero delta ahead of block 0, the blocks
        (:meth:`TransformerStack._block`: causal flash attention under the
        ``flash_ok`` rule, else the unfused branch with the -1e9
        upper-triangle mask), then the final fused LayerNorm and lm_head.
        Dropout (``cfg.dropout`` and ``cfg.attn_dropout``) draws from
        ``generator``, a torch.Generator on the parameters' device; it may
        be None only when both are 0 (then these are the logits of
        ``build_lm(cfg, is_test=True)``, whose attention is flash
        attention)."""
        c = self.cfg
        B, L = tokens.shape
        d = c.d_model
        x = embedding_gather(self.p['tok_emb.w'], tokens).view(B, L, d)
        x = add_position_encoding(x, table=self.pe)
        x = dropout(x, c.dropout, generator)
        mask = None if self.flash_in_training() else torch.triu(
            torch.full((L, L), -1e9, dtype=torch.float32, device=x.device),
            diagonal=1)
        delta = x * 0.0
        for i in range(c.n_layer):
            x, delta = self._block(x, delta, 'layer_%d' % i, causal=True,
                                   mask=mask, dropout_prob=c.dropout,
                                   attn_dropout=c.attn_dropout,
                                   generator=generator)
        x, _ = self._entry_ln(x, delta, 'final_ln')
        return self._fc(x.reshape(B * L, d), 'lm_head', bias=False)

    def loss(self, tokens, labels, generator=None):
        """The mean softmax cross-entropy of `build_lm`'s training program
        for tokens and labels [B, L]: the fused CE over :meth:`logits`.
        Returns a 0-d tensor; call ``.backward()`` on it (or hand it to an
        optimizer's ``minimize``)."""
        return fused_softmax_ce(self.logits(tokens, generator),
                                labels.reshape(-1)).mean()

    @torch.no_grad()
    def prefill(self, prompt, slot, length, sample=None):
        """Run one prompt [1, T] (padded to its bucket T) through the LM,
        write its K/V rows 0..T-1 (pad rows included; decode overwrites
        them) into cache slot ``slot``, and sample the first token from
        the last REAL row ``length - 1``. Attention is causal flash
        attention, or with ``use_flash_attention`` off the unfused branch
        with the -1e9 upper-triangle mask, as `build_lm_prefill`.
        ``slot`` and ``length`` are host ints or 0-d or [1] int64 tensors
        on the model's device (the ``gen_slot`` and ``gen_len`` feeds; a
        CUDA graph needs the tensors). ``sample`` is (temp, topk, topp, u,
        any_sampled) with [1] tensors, or None for greedy. Returns
        (first_token [1] int64, logits [1, V])."""
        T = prompt.shape[1]
        x = add_position_encoding(embedding_gather(self.p['tok_emb.w'],
                                                   prompt), table=self.pe)
        mask = None
        if not self.cfg.use_flash_attention:
            mask = torch.triu(torch.full((T, T), -1e9, dtype=torch.float32,
                                         device=x.device), diagonal=1)

        def attend(q, k, v, i):
            kv_cache_prefill(self.k_cache, k, slot, i)
            kv_cache_prefill(self.v_cache, v, slot, i)
            if mask is None:
                return flash_attention(q, k, v, scale=q.shape[-1] ** -0.5,
                                       causal=True)
            return self._unfused_attention(q, k, v, mask)

        return self._prefill_tower(x, attend, length, sample)

    @torch.no_grad()
    def prefill_paged(self, prompt, positions, table, length, sample=None):
        """Run one prompt suffix [1, T] (padded to its bucket T) into a
        paged slot: its rows sit at global ``positions`` [T] (int64: the
        cached context's length plus t), add those rows of the position
        table, write their K/V rows below ``length`` (the real suffix
        length: a host int or a 0-d or [1] int64 tensor, as
        :meth:`prefill`'s) through the slot's block ``table`` [MB] (pad rows go
        to the trash block) and attend the slot's cache through it, prefix
        included (`kv_prefix_attention`); sample the first token from the
        last real row ``length - 1``. Returns (first_token [1] int64,
        logits [1, V])."""
        positions = positions.reshape(-1)
        x = embedding_gather(self.p['tok_emb.w'], prompt) + \
            self.pe[positions]
        bs = self.block_size

        def attend(q, k, v, i):
            kv_cache_prefill_paged(self.k_cache, k, table, positions, length,
                                   i, bs)
            kv_cache_prefill_paged(self.v_cache, v, table, positions, length,
                                   i, bs)
            return kv_prefix_attention(q, self.k_cache, self.v_cache, table,
                                       positions, i, q.shape[-1] ** -0.5)

        return self._prefill_tower(x, attend, length, sample)

    def _prefill_tower(self, x, attend, length, sample):
        """The prefill programs' tower over the stream x [T, d]: per layer
        the entry LayerNorm, QKV, ``attend(q, k, v, layer)`` (q, k, v [1, H,
        T, dh]: write the cache, return the context [1, H, T, dh]) and
        :meth:`_post_attention`; then the final LayerNorm, the row
        ``length - 1``, lm_head and the sampler."""
        c = self.cfg
        d, h = c.d_model, c.n_head
        dh = d // h
        T = x.shape[0]
        delta = None
        for i in range(c.n_layer):
            p = 'layer_%d' % i
            ln1, x = self._entry_ln(x, delta, p + '.ln1')
            qkv = self._fc(ln1, p + '.attn.qkv')              # [T, 3d]
            qkv = qkv.view(1, T, 3, h, dh).permute(2, 0, 3, 1, 4)
            q, k, v = (qkv[j].contiguous() for j in range(3))  # [1,H,T,dh]
            ctx = attend(q, k, v, i)
            ctx = ctx.permute(0, 2, 1, 3).reshape(T, d)
            x, delta = self._post_attention(x, ctx, p)
        x, _ = self._entry_ln(x, delta, 'final_ln')
        if torch.is_tensor(length):                         # [1, d]
            last = x.index_select(0, length.reshape(1) - 1)
        else:
            last = x[int(length) - 1:int(length)]
        logits = self._fc(last, 'lm_head', bias=False)      # [1, V]
        return self._sample(logits, sample), logits

    def _decode_tower(self, x, write, attend, head=True):
        """The decode programs' tower (`_decode_tower` of the JAX package)
        over per-row state x [R, d] (token embedding + position encoding):
        per layer the entry LayerNorm, QKV, ``write(k, v, layer)`` (k, v [R,
        H, dh]: deposit the rows' K/V), ``attend(q, layer)`` (q [R, H, dh]
        -> context [R, H, dh]) and :meth:`_post_attention`; then the final
        LayerNorm and lm_head. The plain step, each of the drafter's steps
        and the verify step share it, so their arithmetic per row cannot
        drift apart. ``head=False`` stops after the last layer's write and
        returns None: the drafter's trailing step needs every layer's K/V
        deposited but no logits. Returns logits [R, V]."""
        c = self.cfg
        d, h = c.d_model, c.n_head
        dh = d // h
        R = x.shape[0]
        delta = None
        for i in range(c.n_layer):
            p = 'layer_%d' % i
            ln1, x = self._entry_ln(x, delta, p + '.ln1')
            qkv = self._fc(ln1, p + '.attn.qkv').view(R, 3, h, dh)
            q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]       # [R, H, dh]
            write(k, v, i)
            if not head and i == c.n_layer - 1:
                return None
            ctx = attend(q, i)
            x, delta = self._post_attention(x, ctx.reshape(R, d), p)
        x, _ = self._entry_ln(x, delta, 'final_ln')
        return self._fc(x, 'lm_head', bias=False)           # [R, V]

    def _embed(self, tokens, pos):
        """Token embedding + position encoding of rows at ``pos``; a
        position at or past max_len reads the last row of the table, as the
        JAX package's clipping gather does (such a row's output is never
        used and its cache write goes to the trash block)."""
        return embedding_gather(self.p['tok_emb.w'], tokens) + \
            self.pe[torch.clamp(pos, max=self.max_len - 1)]

    @torch.no_grad()
    def decode_step(self, tokens, pos, sample=None, tables=None):
        """Advance every slot by one token: tokens [S] int64 (each slot's
        last token), pos [S] int64 (the cache position each slot writes).
        With a paged cache ``tables`` [S, max_len / block_size] int64 are
        the slots' block tables (an idle slot's row is all zero, so it
        writes to the trash block). Idle slots compute garbage that no one
        reads. Returns (next_tokens [S] int64, logits [S, V])."""
        dh = self.cfg.d_model // self.cfg.n_head
        x = embedding_gather(self.p['tok_emb.w'], tokens) + self.pe[pos]
        if tables is None:
            def write(k, v, i):
                kv_cache_update(self.k_cache, k, pos, i)
                kv_cache_update(self.v_cache, v, pos, i)

            def attend(q, i):
                return kv_decode_attention(q, self.k_cache, self.v_cache,
                                           pos, i, dh ** -0.5)
        else:
            def write(k, v, i):
                kv_cache_update_paged(self.k_cache, k, tables, pos, i,
                                      self.block_size)
                kv_cache_update_paged(self.v_cache, v, tables, pos, i,
                                      self.block_size)

            def attend(q, i):
                return kv_decode_attention_paged(q, self.k_cache,
                                                 self.v_cache, tables, pos,
                                                 i, dh ** -0.5)
        logits = self._decode_tower(x, write, attend)      # [S, V]
        return self._sample(logits, sample), logits

    @torch.no_grad()
    def draft_steps(self, tokens, pos, tables, vmask, k):
        """The drafter of speculative decoding (`build_lm_drafter`): ``k``
        greedy steps over every slot of a paged cache, each step's argmax
        feeding the next step's embedding on the device (no host sync in
        between). tokens [S] int64 (each slot's last accepted token), pos
        [S] int64 (the position step 0 writes; step j writes pos + j),
        tables [S, max_len / block_size] the slots' block tables in this
        model's cache, vmask [S, k + 1] int64 (nonzero: step j's write is
        budgeted; zero rows, idle slots and positions at or past max_len,
        go to the trash block). Runs k + 1 towers: the last only writes
        (``head=False``), depositing the k-th draft's K/V at pos + k, or a
        fully accepted round would leave a hole in the draft cache at the
        target's bonus token. Returns the drafts [S, k] int64 on the
        device."""
        dh = self.cfg.d_model // self.cfg.n_head
        bs = self.block_size
        drafts, tok = [], tokens
        for j in range(int(k) + 1):
            pos_j = pos + j
            valid = vmask[:, j]

            def write(kk, v, i, _pos=pos_j, _valid=valid):
                kv_cache_update_paged(self.k_cache, kk, tables, _pos, i, bs,
                                      valid=_valid)
                kv_cache_update_paged(self.v_cache, v, tables, _pos, i, bs,
                                      valid=_valid)

            def attend(q, i, _pos=pos_j):
                return kv_decode_attention_paged(q, self.k_cache,
                                                 self.v_cache, tables, _pos,
                                                 i, dh ** -0.5)
            logits = self._decode_tower(self._embed(tok, pos_j), write,
                                        attend, head=j < k)
            if j < k:
                tok = torch.argmax(logits, dim=1)
                drafts.append(tok)
        return torch.stack(drafts, dim=1)

    @torch.no_grad()
    def verify_step(self, tokens, pos, tables, vmask):
        """The verify step of speculative decoding (`build_lm_verify`): W
        positions of every slot scored in one pass. Row t of slot s carries
        the token at position pos[s, t] (row 0 the slot's last accepted
        token, rows 1.. the drafts); the S * W rows run through the same
        tower as :meth:`decode_step`, every row's K/V deposited through the
        slot's block table first (`kv_cache_update_span_paged`, rows with
        ``vmask == 0`` to the trash block), then each row attending the
        cache up to its own position (`kv_verify_attention_paged`). So row
        t's logits are what the one-token step computes at that position,
        and their argmax is the acceptance oracle. tokens, pos, vmask [S,
        W] int64 (pos clipped to max_len - 1 by the caller), tables [S,
        max_len / block_size]. Returns (argmax [S * W] int64, logits
        [S * W, V]), row-major."""
        c = self.cfg
        h, dh = c.n_head, c.d_model // c.n_head
        S, W = tokens.shape
        bs = self.block_size

        def span(t):                    # tower rows -> [S, H, W, dh]
            return t.view(S, W, h, dh).permute(0, 2, 1, 3)

        def write(k, v, i):
            kv_cache_update_span_paged(self.k_cache, span(k), tables, pos,
                                       vmask, i, bs)
            kv_cache_update_span_paged(self.v_cache, span(v), tables, pos,
                                       vmask, i, bs)

        def attend(q, i):
            ctx = kv_verify_attention_paged(span(q), self.k_cache,
                                            self.v_cache, tables, pos, i,
                                            dh ** -0.5)
            return ctx.permute(0, 2, 1, 3)              # [S, W, H, dh]
        logits = self._decode_tower(self._embed(tokens.reshape(-1),
                                                pos.reshape(-1)),
                                    write, attend)
        return torch.argmax(logits, dim=1), logits
