"""Attention seq2seq NMT: the port's own copy of paddle_tpu/models/
seq2seq.py (the reference's benchmark/fluid/models/machine_translation.py:53
seq_to_seq_net): a bi-LSTM encoder over the ragged source, a DynamicRNN
decoder with additive attention, teacher-forced training, and beam-search
generation through contrib.decoder. Both builders emit the JAX package's
programs, letter for letter.

The LSTM step (machine_translation.py:32) is one gate fc and a split; the
attention keeps the reference's op sequence (sequence_expand -> concat ->
fc -> sequence_softmax -> weighted sequence_pool) over the ragged source.
Inside the decoder's DynamicRNN those sequence ops read the static LoD of
the encoder's outputs, so their index maps are built once a run plan and a
captured step copies nothing from the host.
"""
from .. import layers

__all__ = ['Seq2SeqConfig', 'build_nmt_train', 'build_nmt_generate']


class Seq2SeqConfig(object):
    def __init__(self, dict_size=30000, embedding_dim=512, encoder_size=512,
                 decoder_size=512, beam_size=3, max_length=250):
        self.dict_size = dict_size
        self.embedding_dim = embedding_dim
        self.encoder_size = encoder_size
        self.decoder_size = decoder_size
        self.beam_size = beam_size
        self.max_length = max_length


def _encoder(cfg, src_word):
    emb = layers.embedding(src_word,
                           size=[cfg.dict_size, cfg.embedding_dim])
    fwd_proj = layers.fc(emb, size=cfg.encoder_size * 4, bias_attr=False)
    fwd, _ = layers.dynamic_lstm(input=fwd_proj, size=cfg.encoder_size * 4,
                                 use_peepholes=False)
    rev_proj = layers.fc(emb, size=cfg.encoder_size * 4, bias_attr=False)
    rev, _ = layers.dynamic_lstm(input=rev_proj, size=cfg.encoder_size * 4,
                                 is_reverse=True, use_peepholes=False)
    enc_vec = layers.concat([fwd, rev], axis=1)        # [T, 2*enc]
    enc_proj = layers.fc(enc_vec, size=cfg.decoder_size, bias_attr=False)
    boot = layers.fc(layers.sequence_pool(rev, 'first'),
                     size=cfg.decoder_size, bias_attr=False, act='tanh')
    return enc_vec, enc_proj, boot


def _attend(cfg, enc_vec, enc_proj, state):
    state_proj = layers.fc(state, size=cfg.decoder_size, bias_attr=False)
    expanded = layers.sequence_expand(state_proj, enc_proj)
    scores = layers.fc(layers.concat([enc_proj, expanded], axis=1),
                       size=1, act='tanh', bias_attr=False)
    weights = layers.sequence_softmax(scores)
    scaled = layers.elementwise_mul(enc_vec,
                                    layers.reshape(weights, [-1]), axis=0)
    return layers.sequence_pool(scaled, 'sum')


def _cell(cfg, inputs, h_prev, c_prev):
    """LSTM step as one fused gate projection (the reference's four
    separate linear() calls compose to the same [4*d] matmul)."""
    gates = layers.fc(layers.concat([inputs, h_prev], axis=1),
                      size=cfg.decoder_size * 4)
    f, i, o, ct = layers.split(gates, num_or_sections=4, dim=1)
    c = layers.elementwise_add(
        layers.elementwise_mul(layers.sigmoid(f), c_prev),
        layers.elementwise_mul(layers.sigmoid(i), layers.tanh(ct)))
    h = layers.elementwise_mul(layers.sigmoid(o), layers.tanh(c))
    return h, c


def build_nmt_train(cfg=None):
    """Training net over ragged LoD feeds: returns (feed names, avg_cost).
    Feeds: source_sequence / target_sequence / label_sequence, each
    lod_level=1 int64 [T, 1]."""
    cfg = cfg or Seq2SeqConfig()
    src = layers.data(name='source_sequence', shape=[1], dtype='int64',
                      lod_level=1)
    trg = layers.data(name='target_sequence', shape=[1], dtype='int64',
                      lod_level=1)
    label = layers.data(name='label_sequence', shape=[1], dtype='int64',
                        lod_level=1)
    enc_vec, enc_proj, boot = _encoder(cfg, src)
    trg_emb = layers.embedding(trg, size=[cfg.dict_size,
                                          cfg.embedding_dim])

    rnn = layers.DynamicRNN()
    with rnn.block():
        word = rnn.step_input(trg_emb)
        vec = rnn.static_input(enc_vec)
        proj = rnn.static_input(enc_proj)
        h_mem = rnn.memory(init=boot, need_reorder=True)
        c_mem = rnn.memory(value=0.0, shape=[cfg.decoder_size])
        context = _attend(cfg, vec, proj, h_mem)
        h, c = _cell(cfg, layers.concat([context, word], axis=1),
                     h_mem, c_mem)
        rnn.update_memory(h_mem, h)
        rnn.update_memory(c_mem, c)
        rnn.output(layers.fc(h, size=cfg.dict_size, act='softmax'))
    prediction = rnn()
    cost = layers.cross_entropy(input=prediction, label=label)
    avg_cost = layers.mean(cost)
    return ['source_sequence', 'target_sequence', 'label_sequence'], \
        avg_cost, prediction


def build_nmt_generate(cfg=None, max_len=None):
    """Beam-search generation (the reference is_generating=True branch;
    NOT part of the reference's benchmark harness, which trains only —
    machine_translation.py:203 passes is_generating=False). The decoder
    cell runs under the dense-beam layout of contrib.decoder
    (batch*beam lanes); the ragged attention step is omitted here because
    beam lanes are not LoD sequences — the generation row times the
    beam machinery + decoder cell + vocab projection.

    Feeds: source_sequence (LoD), init_ids/init_scores [batch*beam, 1]
    (contrib.decoder.BeamSearchDecoder.make_initial_beams). Returns
    (feed names, (sent_ids, sent_scores))."""
    cfg = cfg or Seq2SeqConfig()
    max_len = max_len or cfg.max_length
    from ..contrib.decoder import (BeamSearchDecoder, InitState, StateCell)
    src = layers.data(name='source_sequence', shape=[1], dtype='int64',
                      lod_level=1)
    enc_vec, enc_proj, boot = _encoder(cfg, src)
    init_ids = layers.data(name='init_ids', shape=[-1, 1], dtype='int64')
    init_scores = layers.data(name='init_scores', shape=[-1, 1],
                              dtype='float32')
    # each source instance's boot state replicates over its beam lanes
    boot_beams = layers.expand(boot, [1, cfg.beam_size])
    boot_beams = layers.reshape(boot_beams, [-1, cfg.decoder_size])
    state = InitState(init_boot=boot_beams,
                      shape=[-1, cfg.decoder_size], value=0.0)
    czero = InitState(init_boot=layers.fill_constant_batch_size_like(
        boot_beams, shape=[-1, cfg.decoder_size], value=0.0,
        dtype='float32'), shape=[-1, cfg.decoder_size], value=0.0)
    cell = StateCell(inputs={'x': None}, states={'h': state, 'c': czero},
                     out_state='h')

    @cell.state_updater
    def _update(c):
        x = c.get_input('x')
        h, cc = _cell(cfg, x, c.get_state('h'), c.get_state('c'))
        c.set_state('h', h)
        c.set_state('c', cc)

    dec = BeamSearchDecoder(
        cell, init_ids, init_scores, target_dict_dim=cfg.dict_size,
        word_dim=cfg.embedding_dim, beam_size=cfg.beam_size,
        max_len=max_len, end_id=1)
    dec.decode()
    sent_ids, sent_scores = dec()
    return ['source_sequence', 'init_ids', 'init_scores'], \
        (sent_ids, sent_scores)
