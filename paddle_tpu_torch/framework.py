"""Places, device resolution and the program IR.

Places: the port runs on an NVIDIA GPU. Entry points take ``device=None``
to mean ``cuda:0``; the CPU is used only when the caller asks for it
(``device='cpu'`` or a ``CPUPlace``), which is how the tests run. With no
card and no explicit CPU request, :func:`resolve_device` raises instead of
quietly running on the CPU.

The program IR is the port's own copy of paddle_tpu/framework.py:
``Variable``, ``Parameter``, ``Operator``, ``Block`` and ``Program`` (with
``clone``, ``_role_guard`` and ``random_seed``), the default programs,
``switch_*_program`` and ``program_guard``. It is build-time Python: a
Program built here names, shapes and wires its ops exactly as the JAX
package builds it (the two serialize to the same dict,
core/serialization.py). The Executor (executor.py) runs it op by op on
torch tensors. ``Variable`` has the JAX one's ``astype`` and operators
(``+ - * / **``, their reflected forms, unary ``-`` and ``< <= > >=``),
each appending the ops of ``layers/math_op_patch.binary_op``; like the JAX
one it has no ``==``, so that Variables stay dict keys.
"""
import collections
import contextlib
import copy
import os

import torch

from . import unique_name
from .core.types import VarType, convert_np_dtype_to_dtype_, dtype_str

__all__ = [
    'CPUPlace', 'CUDAPlace', 'cpu_places', 'cuda_places', 'resolve_device',
    'Program', 'Block', 'Operator', 'Variable', 'Parameter',
    'default_startup_program', 'default_main_program', 'program_guard',
    'switch_main_program', 'switch_startup_program', 'grad_var_name',
]


class CPUPlace(object):
    """The host CPU."""

    def __repr__(self):
        return 'CPUPlace()'

    def torch_device(self):
        return torch.device('cpu')


class CUDAPlace(object):
    """One CUDA card, by index."""

    def __init__(self, device_id=0):
        self.device_id = int(device_id)

    def __repr__(self):
        return 'CUDAPlace(%d)' % self.device_id

    def torch_device(self):
        return torch.device('cuda', self.device_id)


def cpu_places(device_count=None):
    """``device_count`` CPU places (None: the ``CPU_NUM`` environment
    variable, 1 without it)."""
    if device_count is None:
        device_count = int(os.environ.get('CPU_NUM', 1))
    return [CPUPlace() for _ in range(device_count)]


def cuda_places(device_ids=None):
    """A CUDA place for each of ``device_ids`` (None: every visible card)."""
    if device_ids is None:
        device_ids = range(torch.cuda.device_count())
    return [CUDAPlace(i) for i in device_ids]


def resolve_device(device=None):
    """A ``torch.device`` for ``device`` (None, a place, a string or a
    torch.device). None means ``cuda:0``. A CUDA device without a usable
    card raises RuntimeError — pass ``device='cpu'`` to run on the CPU."""
    if device is None:
        dev = torch.device('cuda', 0)
    elif isinstance(device, (CPUPlace, CUDAPlace)):
        dev = device.torch_device()
    else:
        dev = torch.device(device)
    if dev.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch runs on a CUDA card by default and none "
                "is available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device('cuda', torch.cuda.current_device())
    elif dev.type != 'cpu':
        raise RuntimeError("unsupported device %r: paddle_tpu_torch runs "
                           "on 'cuda' or 'cpu'" % (str(dev),))
    return dev


GRAD_VAR_SUFFIX = '@GRAD'


def grad_var_name(var_name):
    return var_name + GRAD_VAR_SUFFIX


# ---------------------------------------------------------------------------
# Variable
# ---------------------------------------------------------------------------

class Variable(object):
    """A named slot in a Block: name, shape (-1 for the batch dimension),
    numpy dtype, lod_level, persistable, stop_gradient. A persistable
    Variable is state: it lives in a Scope across executor runs."""

    def __init__(self, block, name=None, shape=None, dtype='float32',
                 lod_level=0, persistable=False, stop_gradient=False,
                 type=VarType.LOD_TENSOR, is_data=False, need_check_feed=False,
                 initializer=None, **kwargs):
        self.block = block
        if name is None:
            name = unique_name.generate('_generated_var')
        self.name = name
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = convert_np_dtype_to_dtype_(dtype) if dtype else None
        self.lod_level = lod_level
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.type = type
        self.is_data = is_data
        self.op = None  # producing op, set by append_op

    def to_string(self, throw_on_error=False, with_details=False):
        return ("var %s : %s shape=%s dtype=%s lod=%d persistable=%s"
                % (self.name, self.type, self.shape,
                   dtype_str(self.dtype) if self.dtype else None,
                   self.lod_level, self.persistable))

    __repr__ = __str__ = lambda self: self.to_string()

    @property
    def grad_name(self):
        return grad_var_name(self.name)

    def astype(self, dtype):
        from .layers import tensor
        return tensor.cast(self, dtype)

    def _binary(self, other, op, reverse=False):
        from .layers import math_op_patch
        return math_op_patch.binary_op(self, other, op, reverse)

    def __add__(self, o): return self._binary(o, 'elementwise_add')
    def __radd__(self, o): return self._binary(o, 'elementwise_add', True)
    def __sub__(self, o): return self._binary(o, 'elementwise_sub')
    def __rsub__(self, o): return self._binary(o, 'elementwise_sub', True)
    def __mul__(self, o): return self._binary(o, 'elementwise_mul')
    def __rmul__(self, o): return self._binary(o, 'elementwise_mul', True)
    def __truediv__(self, o): return self._binary(o, 'elementwise_div')
    def __rtruediv__(self, o): return self._binary(o, 'elementwise_div', True)
    def __pow__(self, o): return self._binary(o, 'elementwise_pow')
    def __rpow__(self, o): return self._binary(o, 'elementwise_pow', True)
    def __neg__(self): return self._binary(-1.0, 'elementwise_mul')
    def __lt__(self, o): return self._binary(o, 'less_than')
    def __le__(self, o): return self._binary(o, 'less_equal')
    def __gt__(self, o): return self._binary(o, 'greater_than')
    def __ge__(self, o): return self._binary(o, 'greater_equal')


class Parameter(Variable):
    """A trainable persistable variable."""

    def __init__(self, block, shape, dtype, **kwargs):
        kwargs.setdefault('persistable', True)
        self.trainable = kwargs.pop('trainable', True)
        self.optimize_attr = kwargs.pop('optimize_attr',
                                        {'learning_rate': 1.0})
        self.regularizer = kwargs.pop('regularizer', None)
        self.gradient_clip_attr = kwargs.pop('gradient_clip_attr', None)
        self.do_model_average = kwargs.pop('do_model_average', None)
        self.initializer = kwargs.pop('initializer', None)
        super(Parameter, self).__init__(block, shape=shape, dtype=dtype,
                                        stop_gradient=False, **kwargs)


# ---------------------------------------------------------------------------
# Operator
# ---------------------------------------------------------------------------

# the attrs under which control-flow ops name their body blocks (while and
# recurrent: sub_block; IfElse's pair): every walk over nested blocks uses
# this one list
SUB_BLOCK_ATTRS = ('sub_block', 'sub_block_true', 'sub_block_false')


class Operator(object):
    """One op in a block: type, named input/output variable-name lists and
    attrs. ``role`` is the program's role when the op was appended
    (Forward, Backward, Optimize)."""

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None):
        self.block = block
        self.type = type
        self.attrs = dict(attrs or {})
        self.role = block.program._current_role

        def _canon(d):
            out = collections.OrderedDict()
            for slot, vs in (d or {}).items():
                if vs is None:
                    out[slot] = []
                    continue
                if not isinstance(vs, (list, tuple)):
                    vs = [vs]
                out[slot] = [v.name if isinstance(v, Variable) else v
                             for v in vs]
            return out

        self.inputs = _canon(inputs)
        self.outputs = _canon(outputs)

    def input(self, slot):
        return self.inputs.get(slot, [])

    def output(self, slot):
        return self.outputs.get(slot, [])

    @property
    def input_arg_names(self):
        return [n for vs in self.inputs.values() for n in vs]

    @property
    def output_arg_names(self):
        return [n for vs in self.outputs.values() for n in vs]

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def set_attr(self, name, val):
        self.attrs[name] = val
        self.block.program._bump_version()

    has_attr = lambda self, name: name in self.attrs

    def to_string(self):
        ins = ", ".join("%s=%s" % (k, v) for k, v in self.inputs.items())
        outs = ", ".join("%s=%s" % (k, v) for k, v in self.outputs.items())
        return "{%s} = %s(%s) attrs=%s" % (outs, self.type, ins,
                                           {k: v for k, v in self.attrs.items()
                                            if not k.startswith('_')})

    __repr__ = __str__ = to_string


# ---------------------------------------------------------------------------
# Block
# ---------------------------------------------------------------------------

class Block(object):
    """Ordered op list + var table, with a parent chain for sub-blocks."""

    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars = collections.OrderedDict()  # name -> Variable
        self.ops = []

    @property
    def parent_block(self):
        if self.parent_idx < 0:
            return None
        return self.program.block(self.parent_idx)

    def create_var(self, **kwargs):
        name = kwargs.get('name')
        if name and name in self.vars:
            return self.vars[name]
        v = Variable(self, **kwargs)
        self.vars[v.name] = v
        self.program._bump_version()
        return v

    def create_parameter(self, **kwargs):
        p = Parameter(self, **kwargs)
        self.vars[p.name] = p
        self.program._bump_version()
        return p

    def var(self, name):
        v = self.vars.get(name)
        if v is None:
            raise ValueError("var %r not in block %d" % (name, self.idx))
        return v

    def _find_var_recursive(self, name):
        b = self
        while b is not None:
            if name in b.vars:
                return b.vars[name]
            b = b.parent_block
        return None

    def has_var(self, name):
        return name in self.vars

    def all_parameters(self):
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def append_op(self, type=None, inputs=None, outputs=None, attrs=None):
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.append(op)
        for vs in op.outputs.values():
            for n in vs:
                v = self._find_var_recursive(n)
                if v is not None and v.op is None:
                    v.op = op
        self.program._bump_version()
        return op

    def _insert_op(self, index, type=None, inputs=None, outputs=None,
                   attrs=None):
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.insert(index, op)
        self.program._bump_version()
        return op

    def to_string(self):
        lines = ["block %d (parent %d):" % (self.idx, self.parent_idx)]
        for v in self.vars.values():
            lines.append("  " + v.to_string())
        for op in self.ops:
            lines.append("  " + op.to_string())
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Program
# ---------------------------------------------------------------------------

_program_uid_counter = 0


def _next_uid():
    global _program_uid_counter
    _program_uid_counter += 1
    return _program_uid_counter


class Program(object):
    """A whole computation: a list of blocks, block 0 global. ``_uid`` and
    ``_version`` (bumped on every mutation) key the executor's run plans."""

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self.current_block_idx = 0
        self.random_seed = 0
        self._version = 0
        self._uid = _next_uid()
        self._seed_counter = 0
        self._is_test = False
        self._current_role = 'Forward'

    @contextlib.contextmanager
    def _role_guard(self, role):
        """Ops appended inside get ``role``."""
        prev, self._current_role = self._current_role, role
        try:
            yield
        finally:
            self._current_role = prev

    def global_block(self):
        return self.blocks[0]

    def block(self, idx):
        return self.blocks[idx]

    def current_block(self):
        return self.blocks[self.current_block_idx]

    def _create_block(self, parent_idx=None):
        """Append a block whose parent is the current block (or
        ``parent_idx``) and make it current."""
        new_idx = len(self.blocks)
        parent = self.current_block_idx if parent_idx is None else parent_idx
        self.blocks.append(Block(self, new_idx, parent))
        self.current_block_idx = new_idx
        self._bump_version()
        return self.current_block()

    def _rollback(self):
        """Make the current block's parent current again."""
        self.current_block_idx = self.current_block().parent_idx

    def _bump_version(self):
        self._version += 1

    def _fingerprint(self):
        """Structural identity (the JAX package's `Program._fingerprint`): a
        sha1 of the serialized program (core/serialization.py, random_seed
        included), so two identical programs share it and an equal program
        of the JAX package has the same one; the observability tier keys
        its per-program series on it. Falls back to the uid for a program
        whose attrs the schema cannot encode. Cached per (version,
        random_seed)."""
        cached = getattr(self, '_fp_cache', None)
        if cached is not None and cached[0] == (self._version,
                                                self.random_seed):
            return cached[1]
        try:
            import hashlib
            import json
            from .core import serialization
            blob = serialization.program_to_dict(self)
            fp = 'fp:' + hashlib.sha1(
                json.dumps(blob, sort_keys=True,
                           separators=(',', ':')).encode()).hexdigest()
        except Exception:
            fp = 'uid:%d:%d:%s' % (self._uid, self._version,
                                   self.random_seed)
        self._fp_cache = ((self._version, self.random_seed), fp)
        return fp

    def clone(self, for_test=False):
        """A deep copy with a fresh identity; ``for_test`` sets every op's
        ``is_test`` attr (dropout's too)."""
        p = copy.deepcopy(self)
        p._uid = _next_uid()
        p._is_test = for_test or self._is_test
        if for_test:
            for block in p.blocks:
                for op in block.ops:
                    if 'is_test' in op.attrs or op.type == 'dropout':
                        op.attrs['is_test'] = True
        p._bump_version()
        return p

    def _prune(self, targets):
        """A clone that keeps only the ops needed to compute ``targets``
        (names or Variables), walking back from them: a kept op's reads
        become needed; an op with a ``sub_block`` is kept when the
        sub-block (with its own sub-blocks) writes a needed var, and then
        the sub-block's reads become needed too (sub-blocks stay whole).
        Vars that no kept op touches are dropped, but for persistables and
        the targets. Used by ``io.save_inference_model``."""
        names = set(t.name if isinstance(t, Variable) else t
                    for t in targets)
        p = self.clone()

        def block_io(bidx, seen):
            """(reads, writes) of a block and its nested sub-blocks."""
            if bidx in seen:
                return set(), set()
            seen.add(bidx)
            reads, writes = set(), set()
            for op in p.block(bidx).ops:
                reads.update(op.input_arg_names)
                writes.update(op.output_arg_names)
                sb = op.attrs.get('sub_block')
                if isinstance(sb, int):
                    r, w = block_io(sb, seen)
                    reads |= r
                    writes |= w
            return reads, writes

        def op_io(op):
            reads, writes = set(op.input_arg_names), \
                set(op.output_arg_names)
            sb = op.attrs.get('sub_block')
            if isinstance(sb, int):
                r, w = block_io(sb, set())
                reads |= r
                writes |= w
            return reads, writes

        gb = p.global_block()
        needed = set(names)
        kept = []
        for op in reversed(gb.ops):
            reads, writes = op_io(op)
            if writes & needed or op.type == 'feed':
                kept.append(op)
                needed |= reads
        kept.reverse()
        gb.ops = kept
        used = set()
        for op in kept:
            reads, writes = op_io(op)
            used |= reads | writes
        gb.vars = collections.OrderedDict(
            (k, v) for k, v in gb.vars.items()
            if k in used or k in names or v.persistable)
        p._bump_version()
        return p

    def list_vars(self):
        for block in self.blocks:
            for v in block.vars.values():
                yield v

    def all_parameters(self):
        return [v for b in self.blocks for v in b.vars.values()
                if isinstance(v, Parameter)]

    def to_string(self, throw_on_error=False, with_details=False):
        return "\n".join(b.to_string() for b in self.blocks)

    __repr__ = __str__ = lambda self: self.to_string()

    @property
    def num_blocks(self):
        return len(self.blocks)


# ---------------------------------------------------------------------------
# Default programs + guards
# ---------------------------------------------------------------------------

_main_program_ = Program()
_startup_program_ = Program()


def default_startup_program():
    return _startup_program_


def default_main_program():
    return _main_program_


def switch_main_program(program):
    global _main_program_
    prev, _main_program_ = _main_program_, program
    return prev


def switch_startup_program(program):
    global _startup_program_
    prev, _startup_program_ = _startup_program_, program
    return prev


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    prev_main = switch_main_program(main_program)
    prev_start = None
    if startup_program is not None:
        prev_start = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(prev_main)
        if prev_start is not None:
            switch_startup_program(prev_start)
