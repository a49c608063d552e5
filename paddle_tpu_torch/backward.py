"""Program-level autodiff: ``append_backward``.

The port's own copy of paddle_tpu/backward.py `append_backward`: it appends
ONE ``backward`` meta-op (input ``Loss``, attr ``wrt_names``, outputs
``Grads`` named ``<param>@GRAD``), the JAX package's op letter for letter.
The executor (core/lowering.py) runs the ops before it under
``torch.enable_grad()`` and binds each gradient with ``torch.autograd.grad``;
each kernel's backward is its ``autograd.Function``'s. Sparse embedding
gradients (``is_sparse=True`` tables) and rematerialization
(``checkpoints=``) wait for a later slice and raise NotImplementedError.
"""
from .framework import Variable, grad_var_name
from .core.types import VarType

__all__ = ['append_backward']


def _sparse_tables(program, param_names):
    """Parameters read by an ``is_sparse`` lookup: the JAX package keeps
    their gradients sparse (a SelectedRows)."""
    names = set(param_names)
    return sorted(n for block in program.blocks for op in block.ops
                  if op.type in ('lookup_table', 'fused_embedding_gather')
                  and op.attr('is_sparse', False)
                  for n in op.input('W') if n in names)


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
    sparse = _sparse_tables(program, [p.name for p in params])
    if sparse:
        raise NotImplementedError(
            'append_backward: sparse embedding gradients (is_sparse=True '
            'tables %s) wait for a later slice of paddle_tpu_torch' % sparse)

    grad_vars = [block.create_var(
        name=grad_var_name(p.name), shape=p.shape, dtype=p.dtype,
        persistable=False, stop_gradient=False, type=VarType.LOD_TENSOR)
        for p in params]
    with program._role_guard('Backward'):
        block.append_op(
            type='backward',
            inputs={'Loss': [loss]},
            outputs={'Grads': grad_vars},
            attrs={'wrt_names': [p.name for p in params],
                   'sparse_wrt': []})
    return list(zip(params, grad_vars))
