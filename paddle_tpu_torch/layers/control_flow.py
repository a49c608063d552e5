"""Control-flow layers: the comparisons, ``While``, ``StaticRNN``,
``DynamicRNN``, ``ConditionalBlock``, ``Switch``, ``IfElse``, the tensor
arrays, the LoD glue of the reference's DynamicRNN and beam search.

The port's own copy of paddle_tpu/layers/control_flow.py: each layer
appends the JAX layer's ops, letter for letter (type, input and output
slots, attrs, sub-blocks), and the lowerings (ops/control_flow_ops.py)
run the sub-blocks on the device. ``While(max_trip_count=)`` bounds a
loop: it can then be differentiated and captured by `Executor.bind` and
``run_fused``.
"""
import contextlib

from ..layer_helper import LayerHelper

__all__ = [
    'While', 'StaticRNN', 'DynamicRNN', 'IfElse', 'Switch',
    'ConditionalBlock', 'less_than', 'less_equal', 'greater_than',
    'greater_equal', 'equal', 'not_equal', 'array_write', 'array_read',
    'array_length', 'create_array', 'increment', 'lod_rank_table',
    'max_sequence_len', 'lod_tensor_to_array', 'array_to_lod_tensor',
    'shrink_memory', 'reorder_lod_tensor_by_rank', 'split_lod_tensor',
    'merge_lod_tensor', 'beam_search', 'beam_search_decode', 'is_empty',
    'tensor_array_to_tensor',
]


def _cmp(op_type, x, y, cond=None):
    helper = LayerHelper(op_type)
    if cond is None:
        cond = helper.create_variable_for_type_inference(dtype='bool',
                                                         shape=x.shape)
    helper.append_op(type=op_type, inputs={'X': [x], 'Y': [y]},
                     outputs={'Out': [cond]})
    return cond


def less_than(x, y, force_cpu=None, cond=None):
    return _cmp('less_than', x, y, cond)


def less_equal(x, y, cond=None):
    return _cmp('less_equal', x, y, cond)


def greater_than(x, y, cond=None):
    return _cmp('greater_than', x, y, cond)


def greater_equal(x, y, cond=None):
    return _cmp('greater_equal', x, y, cond)


def equal(x, y, cond=None):
    return _cmp('equal', x, y, cond)


def not_equal(x, y, cond=None):
    return _cmp('not_equal', x, y, cond)


def increment(x, value=1.0, in_place=True):
    from .nn import increment as _inc
    return _inc(x, value, in_place)


def is_empty(x, cond=None):
    helper = LayerHelper('is_empty')
    if cond is None:
        cond = helper.create_variable_for_type_inference(dtype='bool',
                                                         shape=[1])
    helper.append_op(type='is_empty', inputs={'X': [x]},
                     outputs={'Out': [cond]})
    return cond


# ---------------------------------------------------------------------------
# TensorArray layers
# ---------------------------------------------------------------------------

def create_array(dtype, capacity=None):
    """LOD_TENSOR_ARRAY variable. `capacity` bounds the array, a buffer of
    static shape (where the reference's vector grows on write); default
    128."""
    helper = LayerHelper('create_array')
    out = helper.create_variable_for_type_inference(dtype=dtype, shape=[])
    helper.append_op(type='create_tensor_array', outputs={'Out': [out]},
                     attrs={'capacity': int(capacity or 128)})
    return out


def array_write(x, i, array=None):
    helper = LayerHelper('array_write')
    if array is None:
        array = create_array(x.dtype)
    helper.append_op(type='write_to_array',
                     inputs={'X': [x], 'I': [i]},
                     outputs={'Out': [array]})
    return array


def array_read(array, i):
    helper = LayerHelper('array_read')
    out = helper.create_variable_for_type_inference(dtype=array.dtype)
    helper.append_op(type='read_from_array',
                     inputs={'X': [array], 'I': [i]},
                     outputs={'Out': [out]})
    return out


def array_length(array):
    helper = LayerHelper('array_length')
    out = helper.create_variable_for_type_inference(dtype='int64', shape=[1])
    helper.append_op(type='lod_array_length', inputs={'X': [array]},
                     outputs={'Out': [out]})
    return out


def tensor_array_to_tensor(input, axis=0, use_stack=False, name=None):
    """Concat (or stack) all elements of a TensorArray (reference
    tensor_array_to_tensor_op.cc). Returns (tensor, index) like the
    reference — index holds each element's size along `axis`."""
    helper = LayerHelper('tensor_array_to_tensor', name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    out_index = helper.create_variable_for_type_inference(dtype='int32')
    helper.append_op(type='tensor_array_to_tensor',
                     inputs={'X': [input]},
                     outputs={'Out': [out], 'OutIndex': [out_index]},
                     attrs={'axis': axis, 'use_stack': use_stack})
    return out, out_index


def lod_rank_table(x, level=0):
    helper = LayerHelper('lod_rank_table')
    out = helper.create_variable_for_type_inference(dtype='int64')
    helper.append_op(type='lod_rank_table', inputs={'X': [x]},
                     outputs={'Out': [out]}, attrs={'level': level})
    return out


def max_sequence_len(rank_table):
    helper = LayerHelper('max_sequence_len')
    out = helper.create_variable_for_type_inference(dtype='int64', shape=[1])
    helper.append_op(type='max_sequence_len',
                     inputs={'RankTable': [rank_table]},
                     outputs={'Out': [out]})
    return out


def lod_tensor_to_array(x, table):
    helper = LayerHelper('lod_tensor_to_array')
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type='lod_tensor_to_array',
                     inputs={'X': [x], 'RankTable': [table]},
                     outputs={'Out': [out]})
    return out


def array_to_lod_tensor(x, table):
    helper = LayerHelper('array_to_lod_tensor')
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type='array_to_lod_tensor',
                     inputs={'X': [x], 'RankTable': [table]},
                     outputs={'Out': [out]})
    return out


def shrink_memory(x, i, table):
    helper = LayerHelper('shrink_memory')
    out = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                    shape=x.shape)
    helper.append_op(type='shrink_rnn_memory',
                     inputs={'X': [x], 'I': [i], 'RankTable': [table]},
                     outputs={'Out': [out]})
    return out


def reorder_lod_tensor_by_rank(x, rank_table):
    helper = LayerHelper('reorder_lod_tensor_by_rank')
    out = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                    shape=x.shape)
    helper.append_op(type='reorder_lod_tensor_by_rank',
                     inputs={'X': [x], 'RankTable': [rank_table]},
                     outputs={'Out': [out]})
    return out


def split_lod_tensor(input, mask, level=0):
    helper = LayerHelper('split_lod_tensor')
    out_true = helper.create_variable_for_type_inference(dtype=input.dtype,
                                                         shape=input.shape)
    out_false = helper.create_variable_for_type_inference(dtype=input.dtype,
                                                          shape=input.shape)
    helper.append_op(type='split_lod_tensor',
                     inputs={'X': [input], 'Mask': [mask]},
                     outputs={'OutTrue': [out_true], 'OutFalse': [out_false]},
                     attrs={'level': level})
    return out_true, out_false


def merge_lod_tensor(in_true, in_false, x, mask, level=0):
    helper = LayerHelper('merge_lod_tensor')
    out = helper.create_variable_for_type_inference(dtype=in_true.dtype,
                                                    shape=in_true.shape)
    helper.append_op(type='merge_lod_tensor',
                     inputs={'X': [x], 'Mask': [mask],
                             'InTrue': [in_true], 'InFalse': [in_false]},
                     outputs={'Out': [out]}, attrs={'level': level})
    return out


# ---------------------------------------------------------------------------
# While
# ---------------------------------------------------------------------------

class While(object):
    """while-loop over a sub-block; Condition must be re-evaluated (with
    cond=<same var>) inside the block. The carry is the set of parent vars
    the block writes (reference while_op.cc:50).

        i = layers.fill_constant([1], 'int64', 0)
        n = layers.fill_constant([1], 'int64', 10)
        cond = layers.less_than(i, n)
        w = layers.While(cond)
        with w.block():
            i = layers.increment(i)
            layers.less_than(i, n, cond=cond)
    """

    def __init__(self, cond, is_test=False, name=None, max_trip_count=None):
        self.helper = LayerHelper('while', name=name)
        self.cond_var = cond
        # when set, the loop can be differentiated and captured: it runs
        # this many iterations, the finished ones masked
        self.max_trip_count = max_trip_count

    @contextlib.contextmanager
    def block(self):
        main = self.helper.main_program
        parent = main.current_block()
        main._create_block()
        sub = main.current_block()
        try:
            yield
        finally:
            main._rollback()
        attrs = {'sub_block': sub.idx}
        if self.max_trip_count is not None:
            attrs['max_trip_count'] = int(self.max_trip_count)
        parent.append_op(
            type='while',
            inputs={'Condition': [self.cond_var]},
            outputs={},
            attrs=attrs)


# ---------------------------------------------------------------------------
# StaticRNN
# ---------------------------------------------------------------------------

class StaticRNN(object):
    """Time-major static RNN over a sub-block (reference control_flow.py StaticRNN:278 / recurrent_op.cc).

        rnn = StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)           # x: [T, N, D]
            h_prev = rnn.memory(init=h0)      # or shape/value
            h = layers.fc(input=[x_t, h_prev], size=D)
            rnn.update_memory(h_prev, h)
            rnn.step_output(h)
        out = rnn()                           # [T, N, D]
    """

    def __init__(self, name=None):
        self.helper = LayerHelper('static_rnn', name=name)
        self._seq_inputs = []       # (outer var, inner var)
        self._memories = []         # [boot var, pre var, post var|None]
        self._step_outputs = []     # inner vars
        self._outputs = []          # outer vars
        self._sub_block = None

    @contextlib.contextmanager
    def step(self):
        main = self.helper.main_program
        self._parent_block = main.current_block()
        main._create_block()
        self._sub_block = main.current_block()
        try:
            yield
        finally:
            main._rollback()
        self._append(self._parent_block, is_dynamic=False)

    def step_input(self, x):
        if len(x.shape) < 1:
            raise ValueError("StaticRNN step_input must be time-major [T,...]")
        inner = self._sub_block.create_var(
            name=self.helper.name + '.x_t.%d' % len(self._seq_inputs),
            shape=list(x.shape[1:]), dtype=x.dtype)
        self._seq_inputs.append((x, inner))
        return inner

    def memory(self, init=None, shape=None, batch_ref=None, value=0.0,
               init_batch_dim_idx=0, ref_batch_dim_idx=1, dtype='float32'):
        if init is None:
            if shape is None or batch_ref is None:
                raise ValueError(
                    "StaticRNN.memory needs init= or (shape=, batch_ref=)")
            # boot memory lives in the PARENT block (evaluated once before
            # the scan), so append its op there, not in the step block
            parent = self._parent_block
            init = parent.create_var(
                name=self.helper.name + '.boot.%d' % len(self._memories),
                shape=[-1] + list(shape), dtype=dtype)
            parent.append_op(
                type='fill_constant_batch_size_like',
                inputs={'Input': [batch_ref]},
                outputs={'Out': [init]},
                attrs={'shape': [-1] + list(shape), 'value': float(value),
                       'dtype': dtype,
                       'input_dim_idx': ref_batch_dim_idx,
                       'output_dim_idx': init_batch_dim_idx})
        pre = self._sub_block.create_var(
            name=self.helper.name + '.mem.%d' % len(self._memories),
            shape=list(init.shape), dtype=init.dtype)
        self._memories.append([init, pre, None])
        return pre

    def update_memory(self, mem, var):
        for m in self._memories:
            if m[1] is mem or m[1].name == mem.name:
                m[2] = var
                return
        raise ValueError("update_memory: %r is not a StaticRNN memory"
                         % mem.name)

    def step_output(self, o):
        self._step_outputs.append(o)

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def _append(self, parent, is_dynamic):
        for m in self._memories:
            if m[2] is None:
                raise ValueError("memory %r never updated (update_memory)"
                                 % m[1].name)
        outs = []
        for o in self._step_outputs:
            outer = parent.create_var(
                name=self.helper.name + '.out.%d' % len(outs),
                shape=[-1] + list(o.shape), dtype=o.dtype)
            outs.append(outer)
        self._outputs = outs
        last_mems = []
        for m in self._memories:
            lm = parent.create_var(
                name=self.helper.name + '.last.%d' % len(last_mems),
                shape=list(m[0].shape), dtype=m[0].dtype)
            last_mems.append(lm)
        self._last_mems = last_mems
        parent.append_op(
            type='recurrent',
            inputs={'X': [x for x, _ in self._seq_inputs],
                    'Boot': [m[0] for m in self._memories]},
            outputs={'Out': outs, 'LastMem': last_mems},
            attrs={'sub_block': self._sub_block.idx,
                   'xs_inner': [i.name for _, i in self._seq_inputs],
                   'pre_names': [m[1].name for m in self._memories],
                   'post_names': [m[2].name for m in self._memories],
                   'ys_inner': [o.name for o in self._step_outputs],
                   'is_dynamic': is_dynamic})

    def __call__(self, *args):
        if len(self._outputs) == 1:
            return self._outputs[0]
        return self._outputs


# ---------------------------------------------------------------------------
# DynamicRNN
# ---------------------------------------------------------------------------

class DynamicRNN(object):
    """Ragged-batch RNN over LoD sequences (reference DynamicRNN). The
    reference sorts sequences by length and shrinks the running batch
    (lod_rank_table / shrink_rnn_memory); the lowering keeps a static
    [num_seqs] batch and masks finished rows — same math, static shapes.

        drnn = DynamicRNN()
        with drnn.block():
            x_t = drnn.step_input(x)          # x ragged [sumT, D] w/ LoD
            h_prev = drnn.memory(shape=[D], value=0.0)
            h = layers.fc(input=[x_t, h_prev], size=D)
            drnn.update_memory(h_prev, h)
            drnn.output(h)
        out = drnn()                          # ragged [sumT, D], same LoD
    """

    def __init__(self, name=None):
        self.helper = LayerHelper('dynamic_rnn', name=name)
        self._seq_inputs = []
        self._static_inputs = []
        self._memories = []
        self._step_outputs = []
        self._outputs = []
        self._sub_block = None

    @contextlib.contextmanager
    def block(self):
        main = self.helper.main_program
        self._parent_block = main.current_block()
        main._create_block()
        self._sub_block = main.current_block()
        try:
            yield
        finally:
            main._rollback()
        self._append(self._parent_block)

    def step_input(self, x, level=0):
        inner = self._sub_block.create_var(
            name=self.helper.name + '.x_t.%d' % len(self._seq_inputs),
            shape=[-1] + list(x.shape[1:]), dtype=x.dtype)
        self._seq_inputs.append((x, inner))
        return inner

    def static_input(self, x):
        # visible in the block via closure; kept for API parity
        self._static_inputs.append(x)
        return x

    def memory(self, init=None, shape=None, value=0.0, need_reorder=False,
               dtype='float32'):
        if init is not None:
            boot = init
        else:
            if not self._seq_inputs:
                raise ValueError("call step_input before memory(shape=...)")
            if shape is None:
                raise ValueError("DynamicRNN.memory needs init= or shape=")
            # boot memory op goes into the PARENT block
            parent = self._parent_block
            boot = parent.create_var(
                name=self.helper.name + '.boot.%d' % len(self._memories),
                shape=[-1] + list(shape), dtype=dtype)
            parent.append_op(
                type='drnn_boot_memory',
                inputs={'X': [self._seq_inputs[0][0]]},
                outputs={'Out': [boot]},
                attrs={'shape': list(shape), 'value': float(value),
                       'dtype': dtype})
        pre = self._sub_block.create_var(
            name=self.helper.name + '.mem.%d' % len(self._memories),
            shape=list(boot.shape), dtype=boot.dtype)
        self._memories.append([boot, pre, None])
        return pre

    def update_memory(self, ex_mem, new_mem):
        for m in self._memories:
            if m[1] is ex_mem or m[1].name == ex_mem.name:
                m[2] = new_mem
                return
        raise ValueError("update_memory: %r is not a DynamicRNN memory"
                         % ex_mem.name)

    def output(self, *outputs):
        self._step_outputs.extend(outputs)

    def _append(self, parent):
        for m in self._memories:
            if m[2] is None:
                raise ValueError("memory %r never updated" % m[1].name)
        outs = []
        for o in self._step_outputs:
            outer = parent.create_var(
                name=self.helper.name + '.out.%d' % len(outs),
                shape=[-1] + list(o.shape[1:]), dtype=o.dtype)
            outs.append(outer)
        self._outputs = outs
        last_mems = []
        for m in self._memories:
            lm = parent.create_var(
                name=self.helper.name + '.last.%d' % len(last_mems),
                shape=list(m[0].shape), dtype=m[0].dtype)
            last_mems.append(lm)
        self._last_mems = last_mems
        parent.append_op(
            type='recurrent',
            inputs={'X': [x for x, _ in self._seq_inputs],
                    'Boot': [m[0] for m in self._memories]},
            outputs={'Out': outs, 'LastMem': last_mems},
            attrs={'sub_block': self._sub_block.idx,
                   'xs_inner': [i.name for _, i in self._seq_inputs],
                   'pre_names': [m[1].name for m in self._memories],
                   'post_names': [m[2].name for m in self._memories],
                   'ys_inner': [o.name for o in self._step_outputs],
                   'is_dynamic': True})

    def __call__(self, *args):
        if len(self._outputs) == 1:
            return self._outputs[0]
        return self._outputs


# ---------------------------------------------------------------------------
# ConditionalBlock / Switch / IfElse
# ---------------------------------------------------------------------------

class ConditionalBlock(object):
    """Run a sub-block iff condition holds (reference
    conditional_block_op.cc:72). Only vars that already exist in
    the parent may be written (false branch keeps the old value)."""

    def __init__(self, inputs, is_scalar_condition=False, name=None):
        self.helper = LayerHelper('conditional_block', name=name)
        self.inputs = inputs if isinstance(inputs, (list, tuple)) \
            else [inputs]
        self.is_scalar_condition = is_scalar_condition

    @contextlib.contextmanager
    def block(self):
        main = self.helper.main_program
        parent = main.current_block()
        main._create_block()
        sub = main.current_block()
        try:
            yield
        finally:
            main._rollback()
        parent.append_op(
            type='conditional_block',
            inputs={'Cond': list(self.inputs)},
            outputs={},
            attrs={'sub_block': sub.idx,
                   'is_scalar_condition': self.is_scalar_condition})


class Switch(object):
    """Sequential case dispatch (reference control_flow.py Switch:1138):
    each case runs iff its condition holds and no earlier case fired.
    Used by piecewise learning-rate schedules.

        with layers.Switch() as switch:
            with switch.case(cond):
                layers.assign(a, out)
            with switch.default():
                layers.assign(b, out)
    """

    def __init__(self, name=None):
        self.helper = LayerHelper('switch', name=name)
        self.pre_not_conditions = []

    @contextlib.contextmanager
    def case(self, condition):
        from .nn import logical_and, logical_not
        if len(self.pre_not_conditions) == 0:
            cond = condition
        else:
            pre = self.pre_not_conditions[-1]
            cond = logical_and(x=pre, y=condition)
        not_cond = logical_not(x=condition)
        if self.pre_not_conditions:
            not_cond = logical_and(x=self.pre_not_conditions[-1], y=not_cond)
        self.pre_not_conditions.append(not_cond)
        cb = ConditionalBlock([cond], is_scalar_condition=True)
        with cb.block():
            yield

    @contextlib.contextmanager
    def default(self):
        if not self.pre_not_conditions:
            raise ValueError("default() must follow at least one case()")
        cb = ConditionalBlock([self.pre_not_conditions[-1]],
                              is_scalar_condition=True)
        with cb.block():
            yield

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        return False


class IfElse(object):
    """Row-wise two-branch select (reference control_flow.py IfElse). The
    reference physically splits rows by mask into per-branch tensors; here
    both branches run over the full (static-shape) batch and merge
    row-wise by mask (split_lod_tensor is pass-through, merge_lod_tensor a
    select) — identical results for the row-wise
    bodies the API contract allows."""

    OUT_IF_ELSE_BLOCKS = 2
    IN_IF_ELSE_TRUE_BLOCKS = 0
    IN_IF_ELSE_FALSE_BLOCKS = 1

    def __init__(self, cond, name=None):
        self.helper = LayerHelper('ifelse', name=name)
        self.cond = cond
        self.input_table = {}   # var name -> (true branch var, false var)
        self.status = None
        self.outputs = {0: [], 1: []}

    @contextlib.contextmanager
    def true_block(self):
        self.status = 0
        yield
        self.status = None

    @contextlib.contextmanager
    def false_block(self):
        self.status = 1
        yield
        self.status = None

    def input(self, x):
        if self.status is None:
            raise ValueError("IfElse.input() outside a block")
        if x.name not in self.input_table:
            self.input_table[x.name] = split_lod_tensor(x, self.cond)
        return self.input_table[x.name][self.status]

    def output(self, *outs):
        if self.status is None:
            raise ValueError("IfElse.output() outside a block")
        self.outputs[self.status].extend(outs)

    def __call__(self):
        t, f = self.outputs[0], self.outputs[1]
        if len(t) != len(f):
            raise ValueError(
                "IfElse branches produced different numbers of outputs "
                "(%d vs %d)" % (len(t), len(f)))
        merged = [merge_lod_tensor(a, b, a, self.cond)
                  for a, b in zip(t, f)]
        if len(merged) == 1:
            return merged[0]
        return merged


# ---------------------------------------------------------------------------
# beam search
# ---------------------------------------------------------------------------

def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id,
                level=0, name=None):
    """One dense beam-search step (reference beam_search_op.cc; see
    ops/control_flow_ops.py for the dense-lane design). Returns
    (selected_ids [bw,1], selected_scores [bw,1], parent_idx [bw])."""
    helper = LayerHelper('beam_search', name=name)
    sel_ids = helper.create_variable_for_type_inference(
        dtype='int64', shape=list(pre_ids.shape))
    sel_scores = helper.create_variable_for_type_inference(
        dtype=scores.dtype, shape=list(pre_scores.shape))
    parent_idx = helper.create_variable_for_type_inference(
        dtype='int32', shape=[pre_ids.shape[0]])
    helper.append_op(
        type='beam_search',
        inputs={'pre_ids': [pre_ids], 'pre_scores': [pre_scores],
                'ids': [ids], 'scores': [scores]},
        outputs={'selected_ids': [sel_ids],
                 'selected_scores': [sel_scores],
                 'parent_idx': [parent_idx]},
        attrs={'beam_size': beam_size, 'end_id': end_id, 'level': level})
    return sel_ids, sel_scores, parent_idx


def beam_search_decode(ids, scores, parents, beam_size, end_id, name=None):
    """Backtrack per-step (ids, parents) TensorArrays into sentences:
    (SentenceIds [batch, beam, T], SentenceScores [batch, beam])."""
    helper = LayerHelper('beam_search_decode', name=name)
    sent_ids = helper.create_variable_for_type_inference(dtype='int64')
    sent_scores = helper.create_variable_for_type_inference(dtype='float32')
    helper.append_op(
        type='beam_search_decode',
        inputs={'Ids': [ids], 'Scores': [scores], 'Parents': [parents]},
        outputs={'SentenceIds': [sent_ids],
                 'SentenceScores': [sent_scores]},
        attrs={'beam_size': beam_size, 'end_id': end_id})
    return sent_ids, sent_scores
