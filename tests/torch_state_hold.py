"""The rule that picks the elements of a parameter whose gradient is
rounding noise, for the tests that hold the port's trained state against
the JAX executor's (tests/test_torch_program.py,
tests/test_torch_seq2seq.py). It imports only numpy."""
import numpy as np


def noise_mask(moment1):
    """The elements whose first-step gradient is nonzero but under 1e-5 of
    its tensor's largest, read from the JAX run's first-step Adam moment 1
    (0.1 x the gradient): f32 rounding noise, which Adam's first step turns
    into a move of lr * g / (|g| + 1e-8), so that noise on a gradient near
    1e-8 moves an element by a share of lr. Such an element is held within
    STEPS * lr; every other element to the parameter's own limit."""
    m1 = np.asarray(moment1)
    return (m1 != 0) & (np.abs(m1) < 1e-5 * np.abs(m1).max(initial=0))
