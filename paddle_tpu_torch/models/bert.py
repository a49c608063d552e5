"""BERT-base pretraining: masked-LM and next-sentence losses.

Counterpart of paddle_tpu/models/bert.py: `BertConfig`,
`build_bert_pretrain` (the forward of its program, up to the three losses)
and `make_pretrain_batch`. The encoder is the block the causal LM uses
(:class:`..transformer.TransformerStack`), not causal, with the per-key
padding bias ``input_mask * 1e9 - 1e9`` fused into flash attention when the
``flash_ok`` rule allows it (flash on, and inference or attention dropout
0); otherwise the bias is broadcast to [B, 1, 1, L] into the unfused
matmul, softmax, dropout, matmul. Query rows of padded tokens still attend
(only keys are masked), as in the JAX package.

Parameters carry the JAX names (``bert.tok_emb.w``, ``bert.layer_{i}...``,
``bert.mlm.out.w``, ...) and layouts (fc weights [in, out]); the MLM decoder
``bert.mlm.out.w`` is its own [d_model, vocab] weight, as the JAX program
builds it. The backward is ``torch.autograd`` over :meth:`BertPretrain.loss`.
"""
import collections

import numpy as np
import torch

from ..ops.ce_ops import fused_softmax_ce
from ..ops.embedding_ops import embedding_gather
from ..ops.ffn_ops import _gelu
from ..ops.nn_ops import layer_norm
from ..ops.random_ops import dropout
from ..ops.tensor_ops import add_position_encoding
from . import transformer
from .transformer import LMConfig, TransformerStack, block_param_shapes

__all__ = ['BertConfig', 'BertPretrain', 'param_shapes', 'init_params',
           'make_pretrain_batch']


class BertConfig(LMConfig):
    """BERT's shape: the JAX package's `BertConfig` fields and defaults
    (BERT-base: V 30522, L 128, d 768, 12 heads, 12 layers, d_ff 3072,
    2 segment types, 20 masked positions a sequence, flash attention on)."""

    def __init__(self, vocab_size=30522, seq_len=128, d_model=768,
                 n_head=12, n_layer=12, d_ff=3072, dropout=0.1,
                 type_vocab_size=2, max_predictions=20, attn_dropout=None,
                 use_flash_attention=True):
        LMConfig.__init__(self, vocab_size=vocab_size, seq_len=seq_len,
                          d_model=d_model, n_head=n_head, n_layer=n_layer,
                          d_ff=d_ff, dropout=dropout,
                          attn_dropout=attn_dropout,
                          use_flash_attention=use_flash_attention)
        self.type_vocab_size = type_vocab_size
        self.max_predictions = max_predictions


def param_shapes(cfg):
    """{JAX parameter name: shape}, in the JAX package's creation order."""
    d, V = cfg.d_model, cfg.vocab_size
    shapes = collections.OrderedDict()
    shapes['bert.tok_emb.w'] = (V, d)
    shapes['bert.seg_emb.w'] = (cfg.type_vocab_size, d)
    shapes['bert.emb_ln.w'] = (d,)
    shapes['bert.emb_ln.b'] = (d,)
    for i in range(cfg.n_layer):
        block_param_shapes(shapes, cfg, 'bert.layer_%d' % i)
    shapes['bert.final_ln.w'] = (d,)
    shapes['bert.final_ln.b'] = (d,)
    shapes['bert.mlm.trans.w'] = (d, d)
    shapes['bert.mlm.trans.b'] = (d,)
    shapes['bert.mlm.ln.w'] = (d,)
    shapes['bert.mlm.ln.b'] = (d,)
    shapes['bert.mlm.out.w'] = (d, V)
    shapes['bert.mlm.out.b'] = (V,)
    shapes['bert.pooler.w'] = (d, d)
    shapes['bert.pooler.b'] = (d,)
    shapes['bert.nsp.w'] = (d, 2)
    shapes['bert.nsp.b'] = (2,)
    return shapes


def init_params(cfg, seed, device):
    """Fresh BERT parameters from ``seed``, as
    `transformer.init_params` makes the LM's."""
    return transformer.init_params(cfg, seed, device, param_shapes(cfg))


class BertPretrain(TransformerStack):
    """BERT with its pretraining heads. ``params`` is {JAX parameter name:
    tensor} (`init_params`, or `io.params_from_numpy` of a JAX scope);
    sequences may be up to ``cfg.seq_len`` long."""

    def __init__(self, cfg, params):
        TransformerStack.__init__(self, cfg, params, param_shapes(cfg),
                                  cfg.seq_len)

    def flash_ok(self, is_test):
        """`build_bert_pretrain`'s rule: flash attention when it is on and
        the forward draws no attention dropout."""
        return bool(self.cfg.use_flash_attention and
                    (is_test or not self.cfg.attn_dropout))

    def loss(self, tokens, segments, input_mask, mlm_positions, mlm_labels,
             nsp_labels, generator=None, is_test=False):
        """The losses of `build_bert_pretrain` for one batch: tokens and
        segments [B, L] int64, input_mask [B, L] f32 (1 = a real token),
        mlm_positions [B, P] int64 (flat positions into the [B * L] token
        stream), mlm_labels [B, P] int64, nsp_labels [B, 1] int64. Token
        and segment embeddings (both gathers), position encoding, LayerNorm
        and dropout; the blocks with the padding bias; the final fused
        LayerNorm; the MLM head over the rows at ``mlm_positions`` only
        (fc + erf GELU, LayerNorm, fc to the vocabulary, fused CE, mean);
        the NSP head over each sequence's first position (fc + tanh, fc to
        2, fused CE, mean). ``is_test=True`` draws no dropout; otherwise
        dropout draws from ``generator`` (None only when ``cfg.dropout``
        and ``cfg.attn_dropout`` are 0). Returns (total, mlm, nsp), 0-d
        tensors with total = mlm + nsp."""
        c = self.cfg
        p = self.p
        B, L = tokens.shape
        d = c.d_model
        drop = 0.0 if is_test else c.dropout
        attn_drop = 0.0 if is_test else c.attn_dropout
        x = embedding_gather(p['bert.tok_emb.w'], tokens) + \
            embedding_gather(p['bert.seg_emb.w'], segments)
        x = add_position_encoding(x.view(B, L, d), table=self.pe)
        x = layer_norm(x, p['bert.emb_ln.w'], p['bert.emb_ln.b'])
        x = dropout(x, drop, generator)

        # per-key additive padding bias [B, L]: 0 for a real token, -1e9
        # for a pad
        neg = input_mask.to(torch.float32) * 1e9 - 1e9
        if self.flash_ok(is_test):
            bias, mask = neg, None
        else:
            bias, mask = None, neg.view(B, 1, 1, L)
        delta = x * 0.0
        for i in range(c.n_layer):
            x, delta = self._block(x, delta, 'bert.layer_%d' % i,
                                   causal=False, mask=mask,
                                   key_padding_bias=bias, dropout_prob=drop,
                                   attn_dropout=attn_drop,
                                   generator=generator)
        x, _ = self._entry_ln(x, delta, 'bert.final_ln')

        picked = x.reshape(B * L, d)[mlm_positions.reshape(-1)]
        picked = _gelu(self._fc(picked, 'bert.mlm.trans'))
        picked = layer_norm(picked, p['bert.mlm.ln.w'], p['bert.mlm.ln.b'])
        mlm = fused_softmax_ce(self._fc(picked, 'bert.mlm.out'),
                               mlm_labels.reshape(-1)).mean()

        pooled = torch.tanh(self._fc(x[:, 0], 'bert.pooler'))
        nsp = fused_softmax_ce(self._fc(pooled, 'bert.nsp'),
                               nsp_labels.reshape(-1)).mean()
        return mlm + nsp, mlm, nsp


def make_pretrain_batch(cfg, batch, rng, toks=None):
    """Synthetic pretraining batch with BERT's feed contract, as numpy
    arrays: the port's copy of the JAX package's `make_pretrain_batch` (the
    same draws from the same ``rng``, a numpy RandomState). ``toks``
    overrides the uniform-random token stream (shape [batch, L])."""
    L, P = cfg.seq_len, cfg.max_predictions
    if toks is None:
        toks = rng.randint(4, cfg.vocab_size, (batch, L)).astype('int64')
    else:
        toks = np.asarray(toks, 'int64')
        if toks.shape != (batch, L):
            raise ValueError('toks must have shape %s, got %s'
                             % ((batch, L), toks.shape))
    segs = np.zeros((batch, L), 'int64')
    segs[:, L // 2:] = 1
    mask = np.ones((batch, L), 'float32')
    # a uniform P-subset of each row without replacement, one draw for the
    # whole batch
    pos = np.argsort(rng.rand(batch, L), axis=1)[:, :P]
    flat_pos = (pos + np.arange(batch)[:, None] * L).astype('int64')
    labels = np.take_along_axis(toks, pos, axis=1).astype('int64')
    toks_masked = toks.copy()
    np.put_along_axis(toks_masked, pos, 3, axis=1)   # [MASK] id = 3
    nsp = rng.randint(0, 2, (batch, 1)).astype('int64')
    return {'tokens': toks_masked, 'segments': segs, 'input_mask': mask,
            'mlm_positions': flat_pos, 'mlm_labels': labels,
            'nsp_labels': nsp}
