"""Training and beam-search decoders: the port's own copy of
paddle_tpu/contrib/decoder/beam_search_decoder.py (the reference's
python/paddle/fluid/contrib/decoder/beam_search_decoder.py: InitState :43,
StateCell :159, TrainingDecoder :384, BeamSearchDecoder :523).

The API is the reference's; the decode keeps the JAX package's dense
layout: beams live in [batch*beam] lanes (dead lanes at -1e9, the
``beam_search`` op of ops/control_flow_ops.py), states are parent-block
vars gathered by parent_idx each step, and the loop is a While with
``max_trip_count=max_len``, so that `Executor.bind` captures the whole
decode as one CUDA graph.
"""
import contextlib

import numpy as np

from ... import layers
from ...layers import control_flow

__all__ = ['InitState', 'StateCell', 'TrainingDecoder',
           'BeamSearchDecoder']


class _DecoderType(object):
    TRAINING = 1
    BEAM_SEARCH = 2


class InitState(object):
    """Initial hidden state (reference :43): an explicit variable, or a
    fill_constant_batch_size_like over `init_boot`."""

    def __init__(self, init=None, shape=None, value=0.0, init_boot=None,
                 need_reorder=False, dtype='float32'):
        if init is not None:
            self._init = init
        elif init_boot is None:
            raise ValueError(
                'init_boot must be provided to infer the shape of '
                'InitState.')
        else:
            self._init = layers.fill_constant_batch_size_like(
                input=init_boot, value=value,
                shape=shape or [-1] + list(init_boot.shape[1:]),
                dtype=dtype)
        self._need_reorder = need_reorder

    @property
    def value(self):
        return self._init

    @property
    def need_reorder(self):
        return self._need_reorder


class StateCell(object):
    """Stores the decoder's recurrent state(s) and the updater computing
    the next state from the current inputs (reference :159).

        cell = StateCell(inputs={'x': None}, states={'h': h_init},
                         out_state='h')

        @cell.state_updater
        def updater(cell):
            h_prev = cell.get_state('h')
            x = cell.get_input('x')
            cell.set_state('h', layers.fc([x, h_prev], ...))
    """

    def __init__(self, inputs, states, out_state, name=None):
        self._inputs = dict(inputs)
        self._init_states = dict(states)
        self._state_names = list(states)
        self._out_state = out_state
        self._cur_states = {}
        self._updater = None
        self._decoder = None

    # -- decoder binding ---------------------------------------------------
    def _enter_decoder(self, decoder):
        self._decoder = decoder
        self._cur_states = {}
        if decoder.type == _DecoderType.TRAINING:
            self._mems = {
                n: decoder.dynamic_rnn.memory(
                    init=st.value, need_reorder=st.need_reorder)
                for n, st in self._init_states.items()}
            self._cur_states = dict(self._mems)
        else:
            # beam mode: states are parent-block vars assigned per step
            self._cur_states = {n: st.value
                                for n, st in self._init_states.items()}
        self._pending = {}

    def _leave_decoder(self, decoder):
        self._decoder = None

    # -- user API ----------------------------------------------------------
    def state_updater(self, updater):
        self._updater = updater
        return updater

    def get_state(self, name):
        if name in self._pending:
            return self._pending[name]
        return self._cur_states[name]

    def get_input(self, name):
        if self._cur_inputs.get(name) is None:
            raise ValueError('input %r not provided to compute_state'
                             % name)
        return self._cur_inputs[name]

    def set_state(self, name, value):
        self._pending[name] = value

    def compute_state(self, inputs):
        self._cur_inputs = dict(inputs)
        self._pending = {}
        if self._updater is None:
            raise ValueError('no state_updater registered')
        self._updater(self)

    def update_states(self):
        """Commit pending states (training mode: rnn.update_memory)."""
        if self._decoder is not None and \
                self._decoder.type == _DecoderType.TRAINING:
            for n, new in self._pending.items():
                self._decoder.dynamic_rnn.update_memory(self._mems[n], new)
                self._cur_states[n] = new
        else:
            self._cur_states.update(self._pending)
        self._pending = {}

    def out_state(self):
        return self.get_state(self._out_state)


class TrainingDecoder(object):
    """Teacher-forced decoder over a DynamicRNN (reference :384)."""

    def __init__(self, state_cell, name=None):
        self._rnn = control_flow.DynamicRNN(name=name)
        self._state_cell = state_cell
        self._type = _DecoderType.TRAINING
        self._outputs = []

    @property
    def state_cell(self):
        return self._state_cell

    @property
    def dynamic_rnn(self):
        return self._rnn

    @property
    def type(self):
        return self._type

    @contextlib.contextmanager
    def block(self):
        with self._rnn.block():
            self._state_cell._enter_decoder(self)
            yield
            self._state_cell._leave_decoder(self)

    def step_input(self, x):
        return self._rnn.step_input(x)

    def static_input(self, x):
        return self._rnn.static_input(x)

    def output(self, *outputs):
        self._rnn.output(*outputs)

    def __call__(self, *args, **kwargs):
        return self._rnn(*args, **kwargs)


class BeamSearchDecoder(object):
    """Beam-search decode loop (reference :523). Dense-beam layout:
    init_ids/init_scores are [batch*beam, 1] (lane 0 of each instance
    live, other lanes at -1e9 — use `make_initial_beams` for the standard
    start state).

        decoder = BeamSearchDecoder(cell, init_ids, init_scores,
                                    target_dict_dim=V, word_dim=D,
                                    max_len=T, beam_size=B, end_id=E)
        decoder.decode()
        ids, scores = decoder()     # [batch, B, T], [batch, B]
    """

    def __init__(self, state_cell, init_ids, init_scores, target_dict_dim,
                 word_dim, input_var_dict=None, topk_size=50,
                 sparse_emb=True, max_len=100, beam_size=1, end_id=1,
                 name=None, embedding_param_attr=None,
                 score_param_attr=None, score_bias_attr=None):
        self._state_cell = state_cell
        self._type = _DecoderType.BEAM_SEARCH
        self._init_ids = init_ids
        self._init_scores = init_scores
        self._v = target_dict_dim
        self._word_dim = word_dim
        self._input_var_dict = dict(input_var_dict or {})
        self._topk = min(int(topk_size), int(target_dict_dim))
        self._sparse_emb = sparse_emb
        self._max_len = int(max_len)
        self._beam_size = int(beam_size)
        self._end_id = int(end_id)
        self._emb_attr = embedding_param_attr
        self._score_w_attr = score_param_attr
        self._score_b_attr = score_bias_attr
        self._decoded = None

    @property
    def state_cell(self):
        return self._state_cell

    @property
    def type(self):
        return self._type

    @staticmethod
    def make_initial_beams(batch_size, beam_size, start_id):
        """(init_ids [batch*beam, 1] int64, init_scores [batch*beam, 1]):
        every lane starts at start_id; only lane 0 is live."""
        ids = np.full((batch_size * beam_size, 1), start_id, np.int64)
        scores = np.full((batch_size * beam_size, 1), -1e9, np.float32)
        scores[::beam_size] = 0.0
        return ids, scores

    def decode(self):
        cell = self._state_cell
        cell._enter_decoder(self)
        max_len = self._max_len

        counter = layers.fill_constant(shape=[1], dtype='int64', value=0)
        limit = layers.fill_constant(shape=[1], dtype='int64',
                                     value=max_len)
        ids_arr = control_flow.create_array('int64', capacity=max_len)
        sc_arr = control_flow.create_array('float32', capacity=max_len)
        par_arr = control_flow.create_array('int32', capacity=max_len)

        # carried prev ids/scores + states as parent-block vars
        prev_ids = layers.assign(self._init_ids)
        prev_scores = layers.assign(self._init_scores)
        state_vars = {n: layers.assign(cell._cur_states[n])
                      for n in cell._state_names}

        cond = control_flow.less_than(counter, limit)
        loop = control_flow.While(cond, max_trip_count=max_len)
        with loop.block():
            emb = layers.embedding(
                prev_ids, size=[self._v, self._word_dim],
                is_sparse=self._sparse_emb, param_attr=self._emb_attr)
            emb = layers.reshape(emb, [-1, self._word_dim])
            feed = {}
            for name in cell._inputs:
                feed.setdefault(name, emb)
            for name, var in self._input_var_dict.items():
                feed[name] = var
            cell._cur_states = dict(state_vars)
            cell.compute_state(inputs=feed)
            out_state = cell.out_state()
            probs = layers.fc(out_state, size=self._v, act='softmax',
                              param_attr=self._score_w_attr,
                              bias_attr=self._score_b_attr)
            topk_scores, topk_ids = layers.topk(probs, k=self._topk)
            acc = layers.elementwise_add(
                layers.log(topk_scores), prev_scores)
            sid, ssc, parent = control_flow.beam_search(
                prev_ids, prev_scores, topk_ids, acc,
                beam_size=self._beam_size, end_id=self._end_id, level=0)
            # commit: arrays record this step; states re-gathered by parent
            control_flow.array_write(sid, counter, ids_arr)
            control_flow.array_write(ssc, counter, sc_arr)
            control_flow.array_write(parent, counter, par_arr)
            cell.update_states()
            for n, var in state_vars.items():
                layers.assign(layers.gather(cell._cur_states[n], parent),
                              var)
            layers.assign(sid, prev_ids)
            layers.assign(ssc, prev_scores)
            layers.increment(counter, value=1, in_place=True)
            control_flow.less_than(counter, limit, cond=cond)
        cell._leave_decoder(self)
        self._decoded = (ids_arr, sc_arr, par_arr)

    def __call__(self):
        if self._decoded is None:
            raise ValueError('call decode() before the decoder')
        ids_arr, sc_arr, par_arr = self._decoded
        return layers.beam_search_decode(
            ids_arr, sc_arr, par_arr, beam_size=self._beam_size,
            end_id=self._end_id)
