"""Adam, as Fluid's `AdamOptimizer` keeps it.

Counterpart of paddle_tpu/optimizer.py `AdamOptimizer`. Each parameter has
its moment1, moment2 (zeros, its shape) and its one-element beta1_pow and
beta2_pow (starting at beta1 and beta2), all on the parameters' device; the
learning rate is a one-element tensor there too, as the JAX scope holds
``learning_rate_0``. ``fuse=True`` applies :func:`ops.optimizer_ops
.fused_adam` to the whole set in one launch, as the JAX package's
``fuse=True`` emits one `fused_adam` op; ``fuse=False`` runs the
per-parameter `adam` update.
"""
import collections.abc

import torch

from .ops import optimizer_ops

__all__ = ['Adam']


class Adam(object):
    """``Adam(parameters, learning_rate=1e-3, beta1=0.9, beta2=0.999,
    epsilon=1e-8, fuse=False)``. ``parameters`` is a {name: tensor}
    mapping (such as `TransformerLM.p`) or a sequence of tensors (named by
    position). :meth:`step` applies the update to the parameters that have
    a ``.grad``; :meth:`minimize` is backward, step and clearing the
    gradients, as Fluid's ``minimize`` runs them in one program."""

    def __init__(self, parameters, learning_rate=1e-3, beta1=0.9,
                 beta2=0.999, epsilon=1e-8, fuse=False):
        if isinstance(parameters, collections.abc.Mapping):
            named = list(parameters.items())
        else:
            named = [(str(i), p) for i, p in enumerate(parameters)]
        if not named:
            raise ValueError('Adam needs at least one parameter')
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.beta1 = float(beta1)
        self.beta2 = float(beta2)
        self.epsilon = float(epsilon)
        self.fuse = bool(fuse)
        dev = self.params[0].device
        self.lr = torch.full((1,), float(learning_rate), dtype=torch.float32,
                             device=dev)
        self.moment1 = [torch.zeros_like(p) for p in self.params]
        self.moment2 = [torch.zeros_like(p) for p in self.params]
        self.beta1_pow = [torch.full((1,), self.beta1, dtype=torch.float32,
                                     device=dev) for _ in self.params]
        self.beta2_pow = [torch.full((1,), self.beta2, dtype=torch.float32,
                                     device=dev) for _ in self.params]

    def state(self):
        """{parameter name: {'moment1', 'moment2', 'beta1_pow',
        'beta2_pow'}} — the live tensors, not copies."""
        return {n: dict(moment1=a, moment2=b, beta1_pow=c, beta2_pow=d)
                for n, a, b, c, d in zip(self.names, self.moment1,
                                         self.moment2, self.beta1_pow,
                                         self.beta2_pow)}

    def load_state(self, state, learning_rate=None):
        """Copy ``state`` (as :meth:`state` returns it, tensors or arrays)
        and, if given, the learning rate into this optimizer's tensors."""
        with torch.no_grad():
            for i, n in enumerate(self.names):
                s = state[n]
                for key, dst in (('moment1', self.moment1[i]),
                                 ('moment2', self.moment2[i]),
                                 ('beta1_pow', self.beta1_pow[i]),
                                 ('beta2_pow', self.beta2_pow[i])):
                    dst.copy_(torch.as_tensor(s[key]).reshape(dst.shape))
            if learning_rate is not None:
                self.lr.copy_(torch.as_tensor(learning_rate).reshape(1))

    @torch.no_grad()
    def step(self):
        idx = [i for i, p in enumerate(self.params) if p.grad is not None]
        if not idx:
            return
        pick = lambda xs: [xs[i] for i in idx]
        if self.fuse:
            optimizer_ops.fused_adam(
                pick(self.params), [self.params[i].grad for i in idx],
                pick(self.moment1), pick(self.moment2), pick(self.beta1_pow),
                pick(self.beta2_pow), self.lr, self.beta1, self.beta2,
                self.epsilon)
            return
        for i in idx:
            optimizer_ops.adam(self.params[i], self.params[i].grad,
                               self.moment1[i], self.moment2[i],
                               self.beta1_pow[i], self.beta2_pow[i], self.lr,
                               self.beta1, self.beta2, self.epsilon)

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def backward(self, loss):
        """``loss.backward()``; returns [(parameter, gradient)] for the
        parameters that received one, as Fluid's ``backward`` returns its
        params_grads."""
        loss.backward()
        return [(p, p.grad) for p in self.params if p.grad is not None]

    def apply_gradients(self, params_grads):
        """:meth:`step` over the parameters' gradients (``params_grads`` as
        :meth:`backward` returns them: each parameter's own ``.grad``),
        then clear them."""
        self.step()
        self.zero_grad()

    def minimize(self, loss):
        """:meth:`backward` then :meth:`apply_gradients`, as Fluid's
        ``minimize`` runs them in one program. Returns the loss,
        detached."""
        self.apply_gradients(self.backward(loss))
        return loss.detach()
