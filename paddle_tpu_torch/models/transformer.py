"""The flagship causal LM: training forward and decode.

Counterpart of paddle_tpu/models/transformer.py: `LMConfig`, `build_lm`
(the training program's forward, up to the mean loss) and the decode
programs `build_lm_prefill` and `build_lm_decode_step` (with
`_decode_tower`). The JAX package builds these as Programs; here the LM is
an ``nn.Module`` whose parameters carry the JAX package's names
(``tok_emb.w``, ``layer_{i}.attn.qkv.w``, ...) and layouts — fc weights
stay [in, out], so ``y = x @ W + b`` — so a scope saved by the JAX package
loads as it is (paddle_tpu_torch/io.py). The backward of `build_lm`'s
program is ``torch.autograd`` over :meth:`TransformerLM.loss`.

The residual wiring is the JAX package's: each block's FFN output is left
unadded and fused into the NEXT LayerNorm (``fused_ln_residual``); the final
LayerNorm is fused with the last block's delta. Training puts a zero delta
(``x * 0``) ahead of block 0, so every block's entry LayerNorm is a fused
site (2·L + 1 per forward); decode keeps one plain ``layer_norm`` at layer
0's entry, as the decode programs do.

The KV cache is two [slots, layers, heads, max_len, head_dim] tensors
owned by the module (:meth:`TransformerLM.allocate_cache`), allocated
zeroed and updated in place.

:class:`TransformerStack` holds what the LM shares with BERT
(paddle_tpu_torch/models/bert.py), as `transformer_block` serves both
models in the JAX package: the parameters under their JAX names and the
pre-norm block of the training forward.
"""
import collections

import torch
from torch import nn

from ..ops.attention_ops import flash_attention
from ..ops.ce_ops import fused_softmax_ce
from ..ops.embedding_ops import embedding_gather
from ..ops.ffn_ops import fused_ffn_core
from ..ops.kv_cache_ops import (kv_cache_prefill, kv_cache_update,
                                kv_decode_attention, sample_next_token)
from ..ops.nn_ops import fused_ln_residual, layer_norm
from ..ops.random_ops import dropout, keep_mask
from ..ops.tensor_ops import add_position_encoding, position_encoding_table

__all__ = ['LMConfig', 'TransformerLM', 'TransformerStack', 'param_shapes',
           'block_param_shapes', 'init_params']


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


def _key(name):
    # nn.Module parameter names cannot hold '.'
    return name.replace('.', '__')


class TransformerStack(nn.Module):
    """What the LM and BERT share: the parameters of ``shapes`` under their
    JAX names (``self.p``), the position table ``self.pe`` of ``max_len``
    rows, and the pre-norm block of the training forward
    (:meth:`_block`)."""

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

    @property
    def device(self):
        return next(iter(self.p.values())).device

    def _fc(self, x, name, bias=True):
        y = torch.matmul(x, self.p[name + '.w'])
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
        delta, _ = fused_ffn_core(ln2.reshape(-1, d),
                                  self.p[prefix + '.ffn1.w'],
                                  self.p[prefix + '.ffn1.b'],
                                  self.p[prefix + '.ffn2.w'],
                                  self.p[prefix + '.ffn2.b'], keep)
        return x, delta.view(x.shape)

    def _block(self, x, delta, prefix, causal, mask=None,
               key_padding_bias=None, dropout_prob=0.0, attn_dropout=0.0,
               generator=None):
        """One pre-norm block of a training forward over the stream ``x``
        [B, L, d] with the previous block's pending FFN ``delta``:
        the fused entry LayerNorm, QKV, attention, proj, the fused
        LayerNorm at ln2 and the FFN tail with its dropout mask. Attention
        is flash attention (``causal``, with ``key_padding_bias`` [B, L])
        when ``mask`` is None, as the models' ``flash_ok`` rule decides;
        else the unfused branch of `multi_head_attention`:
        scores * dh^-0.5 + ``mask`` (broadcast to [B, H, L, L]), softmax,
        dropout on the weights, matmul with v. Returns (stream, delta)."""
        B, L, d = x.shape
        h = self.cfg.n_head
        dh = d // h
        ln1, x = self._entry_ln(x, delta, prefix + '.ln1')
        qkv = self._fc(ln1, prefix + '.attn.qkv')
        q, k, v = qkv.view(B, L, 3, h, dh).permute(2, 0, 3, 1, 4)
        if mask is None:
            ctx = flash_attention(q, k, v, scale=dh ** -0.5, causal=causal,
                                  key_padding_bias=key_padding_bias)
        else:
            scores = torch.matmul(q, k.transpose(-1, -2)) * dh ** -0.5 + mask
            weights = dropout(torch.softmax(scores, dim=-1), attn_dropout,
                              generator)
            ctx = torch.matmul(weights, v)
        ctx = ctx.permute(0, 2, 1, 3).reshape(B, L, d)
        keep = keep_mask((B * L, d), dropout_prob, generator, x.device) \
            if dropout_prob else None
        return self._post_attention(x, ctx, prefix, keep)


class TransformerLM(TransformerStack):
    """Decoder-only LM: :meth:`loss` is the training forward of `build_lm`;
    with a KV cache, :meth:`prefill` runs one prompt into a cache slot and
    :meth:`decode_step` advances every slot by one token (both under
    ``torch.no_grad``). ``max_len`` bounds the positions of both: the
    position table has that many rows."""

    def __init__(self, cfg, params, max_len):
        TransformerStack.__init__(self, cfg, params, param_shapes(cfg),
                                  max_len)
        self.k_cache = None
        self.v_cache = None

    def allocate_cache(self, slots):
        """Zeroed K and V caches [slots, layers, heads, max_len, dh]. Zeros,
        not empty memory: stale rows are masked by a select, but they must
        never hold uninitialised bits either."""
        c = self.cfg
        shape = (int(slots), c.n_layer, c.n_head, self.max_len,
                 c.d_model // c.n_head)
        self.k_cache = torch.zeros(shape, dtype=torch.float32,
                                   device=self.device)
        self.v_cache = torch.zeros_like(self.k_cache)

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

    def loss(self, tokens, labels, generator=None):
        """The mean softmax cross-entropy of `build_lm`'s training program
        for tokens and labels [B, L] (int64, L <= max_len): embedding
        gather + position encoding, dropout, a zero delta ahead of block 0,
        the blocks (:meth:`TransformerStack._block`: causal flash attention
        under the ``flash_ok`` rule, else the unfused branch with the -1e9
        upper-triangle mask), then the final fused LayerNorm, lm_head and
        the fused CE. Dropout (``cfg.dropout`` and ``cfg.attn_dropout``)
        draws from ``generator``, a torch.Generator on the parameters'
        device; it may be None only when both are 0. Returns a 0-d tensor;
        call ``.backward()`` on it (or hand it to an optimizer's
        ``minimize``)."""
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
        logits = self._fc(x.reshape(B * L, d), 'lm_head', bias=False)
        return fused_softmax_ce(logits, labels.reshape(-1)).mean()

    @torch.no_grad()
    def prefill(self, prompt, slot, length, sample=None):
        """Run one prompt [1, T] (padded to its bucket T) through the LM,
        write its K/V rows 0..T-1 (pad rows included; decode overwrites
        them) into cache slot ``slot``, and sample the first token from
        the last REAL row ``length - 1``. ``sample`` is (temp, topk, topp,
        u, any_sampled) with [1] tensors, or None for greedy. Returns
        (first_token [1] int64, logits [1, V])."""
        c = self.cfg
        d, h = c.d_model, c.n_head
        dh = d // h
        T = prompt.shape[1]
        x = add_position_encoding(embedding_gather(self.p['tok_emb.w'],
                                                   prompt), table=self.pe)
        delta = None
        for i in range(c.n_layer):
            p = 'layer_%d' % i
            ln1, x = self._entry_ln(x, delta, p + '.ln1')
            qkv = self._fc(ln1, p + '.attn.qkv')              # [T, 3d]
            qkv = qkv.view(1, T, 3, h, dh).permute(2, 0, 3, 1, 4)
            q, k, v = (qkv[j].contiguous() for j in range(3))  # [1,H,T,dh]
            kv_cache_prefill(self.k_cache, k, slot, i)
            kv_cache_prefill(self.v_cache, v, slot, i)
            ctx = flash_attention(q, k, v, scale=dh ** -0.5, causal=True)
            ctx = ctx.permute(0, 2, 1, 3).reshape(T, d)
            x, delta = self._post_attention(x, ctx, p)
        x, _ = self._entry_ln(x, delta, 'final_ln')
        last = x[int(length) - 1:int(length)]               # [1, d]
        logits = self._fc(last, 'lm_head', bias=False)      # [1, V]
        return self._sample(logits, sample), logits

    @torch.no_grad()
    def decode_step(self, tokens, pos, sample=None):
        """Advance every slot by one token: tokens [S] int64 (each slot's
        last token), pos [S] int64 (the cache position each slot writes).
        Idle slots compute garbage that no one reads. Returns
        (next_tokens [S] int64, logits [S, V])."""
        c = self.cfg
        d, h = c.d_model, c.n_head
        dh = d // h
        S = tokens.shape[0]
        x = embedding_gather(self.p['tok_emb.w'], tokens) + self.pe[pos]
        delta = None
        for i in range(c.n_layer):
            p = 'layer_%d' % i
            ln1, x = self._entry_ln(x, delta, p + '.ln1')
            qkv = self._fc(ln1, p + '.attn.qkv').view(S, 3, h, dh)
            q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]       # [S, H, dh]
            kv_cache_update(self.k_cache, k, pos, i)
            kv_cache_update(self.v_cache, v, pos, i)
            ctx = kv_decode_attention(q, self.k_cache, self.v_cache, pos, i,
                                      dh ** -0.5)
            x, delta = self._post_attention(x, ctx.reshape(S, d), p)
        x, _ = self._entry_ln(x, delta, 'final_ln')
        logits = self._fc(x, 'lm_head', bias=False)         # [S, V]
        return self._sample(logits, sample), logits
