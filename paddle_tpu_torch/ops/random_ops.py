"""Dropout in the ``upscale_in_train`` form, and the FFN's keep mask.

Counterpart of paddle_tpu/ops/random_ops.py (the `dropout` lowering) and of
the fused FFN tail's `_dropout_mask` in paddle_tpu/ops/ffn_ops.py. The JAX
package draws ``keep = bernoulli(key, 1 - p)`` from its counted threefry
stream; here every draw takes an explicit ``torch.Generator`` on the
tensor's device (there is no global RNG), so the two packages draw
different bits from the same seed and agree only at ``p = 0``. Neither side
has a Pallas kernel here: the draw and the multiply are plain PyTorch.
"""
import torch

__all__ = ['dropout', 'keep_mask']


def _check_generator(generator, device):
    if generator is None:
        raise ValueError('dropout needs an explicit torch.Generator: the '
                         'port keeps no global random state')
    if torch.device(generator.device).type != torch.device(device).type:
        raise ValueError('the generator lies on %s, the tensor on %s'
                         % (generator.device, device))


def keep_mask(shape, p, generator, device):
    """The float32 keep mask of dropout probability ``p``, pre-scaled for
    ``upscale_in_train``: 1 / (1 - p) where a uniform draw is below 1 - p,
    else 0 (all 0 when p >= 1)."""
    _check_generator(generator, device)
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    if p >= 1.0:
        return torch.zeros_like(u)
    return (u < 1.0 - p).to(torch.float32) / (1.0 - p)


def dropout(x, p, generator=None):
    """``upscale_in_train`` dropout: ``x * keep / (1 - p)`` with keep drawn
    at rate 1 - p (0 everywhere when p >= 1); ``x`` itself when p is 0."""
    if not p:
        return x
    _check_generator(generator, x.device)
    u = torch.rand(x.shape, generator=generator, device=x.device,
                   dtype=torch.float32)
    if p >= 1.0:
        return x * 0.0
    return x * (u < 1.0 - p).to(x.dtype) / (1.0 - p)
