"""Kernel dispatch and launch counts.

The rule is one line: **a CPU tensor takes the plain PyTorch version, a
CUDA tensor launches the hand-written kernel or raises.** There is no
shape rule that steps down to the plain version on the card — where the
JAX package's tier drops to XLA on a shape its Pallas kernel cannot tile,
the CUDA kernels mask their ragged edges themselves, and a shape a kernel
does not take at all raises in its wrapper.

Each wrapper adds one to its kernel's count where it launches the kernel,
and nowhere else (the plain version on the CPU does not count), so a run
can show that its main path went through the kernels. Under CUDA-graph
capture a wrapper runs but the device launches nothing; the capture
(core/graphs.py) takes those counts back and its owner adds them on each
replay.
"""
import threading

import torch

__all__ = ['KERNELS', 'launch_counts', 'reset_counts', 'count',
           'add_counts', 'on_cuda',
           'records_grad', 'require', 'stream_ptr', 'ptr']

# the kernels of the port, by the name their wrapper counts under
KERNELS = ('embedding_gather', 'fused_ln_residual', 'flash_attention',
           'fused_ffn', 'softmax_ce_fwd', 'softmax_ce_bwd',
           'fused_ln_residual_bwd', 'fused_adam', 'flash_attention_bwd_dq',
           'flash_attention_bwd_dkv', 'flash_attention_bf16',
           'flash_attention_bf16_bwd_dq', 'flash_attention_bf16_bwd_dkv',
           'flash_attention_wide', 'flash_attention_wide_bwd_dq',
           'flash_attention_wide_bwd_dkv')

_counts = dict.fromkeys(KERNELS, 0)
_lock = threading.Lock()


def launch_counts():
    """{kernel name: launches since the last reset} (a copy)."""
    with _lock:
        return dict(_counts)


def reset_counts():
    with _lock:
        for k in _counts:
            _counts[k] = 0


def count(name):
    with _lock:
        _counts[name] += 1


def add_counts(delta):
    """Add ``delta`` ({kernel name: launches}) to the counts: a CUDA graph's
    replay runs the launches its capture counted (core/graphs.py)."""
    with _lock:
        for name, n in delta.items():
            _counts[name] += n


def on_cuda(*tensors):
    """True when the (non-None) tensors all lie on a CUDA device, False
    when they all lie on the CPU; raises for a mix or another device."""
    kinds = set(t.device.type for t in tensors if t is not None)
    if kinds == {'cuda'}:
        return True
    if kinds == {'cpu'}:
        return False
    raise RuntimeError('kernel inputs must all lie on one CUDA device or '
                       'all on the CPU, got %s' % sorted(kinds))


def records_grad(*tensors):
    """True when autograd records a call on ``tensors``: grad mode is on
    and one of the (non-None) tensors requires grad. A wrapper then goes
    through its ``autograd.Function``; otherwise (serving, under
    ``no_grad``) it calls the bare forward and keeps no backward's
    residuals."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def require(t, what, shape, dtype=torch.float32, device=None):
    """Validate one kernel operand: dtype, exact shape, contiguity and (if
    given) device. Raises ValueError naming the operand."""
    if t.dtype != dtype:
        raise ValueError('%s must be %s, got %s' % (what, dtype, t.dtype))
    if tuple(t.shape) != tuple(shape):
        raise ValueError('%s must have shape %s, got %s'
                         % (what, tuple(shape), tuple(t.shape)))
    if not t.is_contiguous():
        raise ValueError('%s must be contiguous' % what)
    if device is not None and t.device != device:
        raise ValueError('%s lies on %s, expected %s'
                         % (what, t.device, device))


def stream_ptr(t):
    """PyTorch's current CUDA stream on ``t``'s device, as a raw handle."""
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t):
    """Raw device pointer of a tensor, or None for None."""
    return None if t is None else t.data_ptr()
