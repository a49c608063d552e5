"""Variable kinds and dtypes of the program IR.

The port's own copy of paddle_tpu/core/types.py: ``VarType`` and the
numpy dtype of a variable (a Program's variables carry numpy dtypes in
both packages, so their serialized forms agree), plus the map from a
numpy dtype to the torch dtype its tensors take when a program runs.
"""
import numpy as np
import torch

__all__ = ['VarType', 'convert_np_dtype_to_dtype_', 'dtype_str',
           'is_float_dtype', 'torch_dtype']


class VarType(object):
    LOD_TENSOR = 'lod_tensor'
    SELECTED_ROWS = 'selected_rows'
    LOD_TENSOR_ARRAY = 'lod_tensor_array'
    STEP_SCOPES = 'step_scopes'
    LOD_RANK_TABLE = 'lod_rank_table'
    FETCH_LIST = 'fetch_list'
    FEED_MINIBATCH = 'feed_minibatch'
    READER = 'reader'
    RAW = 'raw'


_STR_TO_NP = {
    'bool': np.bool_,
    'int8': np.int8,
    'uint8': np.uint8,
    'int16': np.int16,
    'int32': np.int32,
    'int64': np.int64,
    'float16': np.float16,
    'float32': np.float32,
    'float64': np.float64,
}

_NP_TO_TORCH = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def convert_np_dtype_to_dtype_(dtype):
    """Normalize a user-provided dtype (str or np dtype) to np.dtype."""
    if isinstance(dtype, str):
        if dtype not in _STR_TO_NP:
            raise ValueError("unsupported dtype %r" % (dtype,))
        return np.dtype(_STR_TO_NP[dtype])
    return np.dtype(dtype)


def dtype_str(dtype):
    return np.dtype(dtype).name


def is_float_dtype(dtype):
    return np.issubdtype(convert_np_dtype_to_dtype_(dtype), np.floating)


def torch_dtype(dtype):
    """The torch dtype of a variable's numpy (or string) dtype."""
    return _NP_TO_TORCH[convert_np_dtype_to_dtype_(dtype)]
