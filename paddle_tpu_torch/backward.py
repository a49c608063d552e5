"""Program-level autodiff: ``append_backward``.

The port's own copy of paddle_tpu/backward.py `append_backward`: it appends
ONE ``backward`` meta-op (input ``Loss``, attr ``wrt_names``, outputs
``Grads`` named ``<param>@GRAD``), the JAX package's op letter for letter.
The executor (core/lowering.py) runs the ops before it under
``torch.enable_grad()`` and binds each gradient with ``torch.autograd.grad``;
each kernel's backward is its ``autograd.Function``'s. A table that only
``is_sparse`` lookups read gets a sparse gradient: its grad var is typed
``SELECTED_ROWS`` and the op lists it in ``sparse_wrt``
(`_find_sparse_params`, the JAX package's). Rematerialization
(``checkpoints=``) waits for a later slice and raises
NotImplementedError. ``calc_gradient`` (alias ``gradients``) appends the
same meta-op for any leaves, fed variables included, as the JAX package's
does.
"""
from .framework import Variable, grad_var_name
from .core.types import VarType

__all__ = ['append_backward', 'calc_gradient', 'gradients']


def _find_sparse_params(program, param_names):
    """Parameters whose gradient stays sparse (a SelectedRows): those that
    every op reading them reads as ``W`` of a main-block ``lookup_table``
    (or ``fused_embedding_gather``) with ``is_sparse``. A sub-block
    reader (carried loop state) keeps the gradient dense."""
    candidates = set(param_names)
    consumed = set()
    for block in program.blocks:
        for op in block.ops:
            if op.type == 'backward':
                continue
            for n in op.input_arg_names:
                if n not in candidates:
                    continue
                if (block.idx == 0
                        and op.type in ('lookup_table',
                                        'fused_embedding_gather')
                        and op.attr('is_sparse', False)
                        and n in op.input('W')):
                    consumed.add(n)
                else:
                    candidates.discard(n)
    return candidates & consumed


def _resolve_no_grad(no_grad_set):
    return set(item.name if isinstance(item, Variable) else item
               for item in (no_grad_set or []))


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None, checkpoints=None):
    """Append the gradient computation of ``loss`` w.r.t. the trainable
    parameters; returns [(parameter, gradient variable)]."""
    program = loss.block.program
    block = program.global_block()
    no_grad = _resolve_no_grad(no_grad_set)
    if checkpoints:
        raise NotImplementedError(
            'append_backward(checkpoints=...): rematerialization waits for '
            'a later slice of paddle_tpu_torch')

    if parameter_list:
        params = [block.var(p) if isinstance(p, str) else p
                  for p in parameter_list]
    else:
        params = [p for p in program.all_parameters()
                  if getattr(p, 'trainable', True)]
    params = [p for p in params if p.name not in no_grad]
    if not params:
        raise ValueError("append_backward: no trainable parameters found")
    sparse = _find_sparse_params(program, [p.name for p in params])

    grad_vars = [block.create_var(
        name=grad_var_name(p.name), shape=p.shape, dtype=p.dtype,
        persistable=False, stop_gradient=False,
        type=(VarType.SELECTED_ROWS if p.name in sparse
              else VarType.LOD_TENSOR))
        for p in params]
    with program._role_guard('Backward'):
        block.append_op(
            type='backward',
            inputs={'Loss': [loss]},
            outputs={'Grads': grad_vars},
            attrs={'wrt_names': [p.name for p in params],
                   'sparse_wrt': sorted(sparse)})
    return list(zip(params, grad_vars))


def calc_gradient(targets, inputs, target_gradients=None, no_grad_set=None):
    """Gradients of ``targets`` (the first one is the loss) w.r.t. the leaf
    ``inputs``, fed variables or parameters: one ``backward`` op whose
    ``wrt_names`` are ``inputs`` minus ``no_grad_set``. Returns the
    gradient variables, named ``<input>@GRAD``."""
    if not isinstance(targets, (list, tuple)):
        targets = [targets]
    if not isinstance(inputs, (list, tuple)):
        inputs = [inputs]
    loss = targets[0]
    block = loss.block
    no_grad = _resolve_no_grad(no_grad_set)
    wrt = [i for i in inputs if i.name not in no_grad]
    grad_vars = [block.create_var(
        name=grad_var_name(v.name), shape=v.shape, dtype=v.dtype,
        persistable=False, stop_gradient=False) for v in wrt]
    with block.program._role_guard('Backward'):
        block.append_op(
            type='backward',
            inputs={'Loss': [loss]},
            outputs={'Grads': grad_vars},
            attrs={'wrt_names': [v.name for v in wrt]})
    return grad_vars


gradients = calc_gradient
