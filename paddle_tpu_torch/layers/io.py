"""Input layers: ``data`` declares a fed variable.

The port's own copy of `data` from paddle_tpu/layers/io.py. Readers
(``py_reader``, ``double_buffer``) wait for the port's reader pipeline.
"""
from ..framework import default_main_program
from ..core.types import VarType

__all__ = ['data']


def data(name, shape, append_batch_size=True, dtype='float32', lod_level=0,
         type=VarType.LOD_TENSOR, stop_gradient=True):
    helper_block = default_main_program().current_block()
    shape = list(shape)
    # a -1 anywhere in shape means the caller gave the full batched shape
    if append_batch_size and not any(d == -1 for d in shape):
        shape = [-1] + shape
    return helper_block.create_var(
        name=name, shape=tuple(shape), dtype=dtype, lod_level=lod_level,
        type=type, stop_gradient=stop_gradient, is_data=True,
        persistable=False)
