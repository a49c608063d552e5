"""The activation op types of paddle_tpu_torch (ops/activations.py: the
30 ported in this slice) and the norm, distance and loss types of
ops/math_ops.py (14), each as a one-op program against the JAX executor
on the CPU (tests/torch_activation_cases.py builds them the same way in
both packages): every output and the gradient of sum(out * ct) w.r.t.
every float input and parameter, float32, within rtol 1e-6 and atol 1e-6.
The inputs hold the clips' ties, the shrinks' thresholds and ``round``'s
halves, where the two libraries' own forms would part (``torch.clamp``
gives a tie's whole gradient to x, JAX half; ``F.softplus`` turns into x
above 20)."""
import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import goodput, monitor
from paddle_tpu.core import registry as jregistry
from paddle_tpu.core import serialization as jser

import paddle_tpu_torch as fluid
from paddle_tpu_torch.core import registry as tregistry
from paddle_tpu_torch.core import serialization as tser

import torch_activation_cases as tac

CASES = tac.cases()


@pytest.fixture(scope='module', autouse=True)
def _fresh_goodput_window():
    """Driving the JAX executor arms the process-wide goodput sentinels and
    fills monitor series; leave both empty after this module."""
    yield
    goodput.reset()
    monitor.reset()


def test_every_type_is_registered_and_has_a_case():
    """The 44 types, registered by the JAX package and the port, each with
    at least one case here."""
    types = tac.ACTIVATIONS + tac.MATH
    assert len(set(types)) == 44
    assert set(types) <= set(tregistry.all_ops())
    assert set(types) <= set(jregistry.all_ops())
    assert {k.split(':')[0] for k in CASES} == set(types)


@pytest.mark.parametrize('key', sorted(CASES))
def test_op_matches_the_jax_executor(key):
    case = CASES[key]
    jmain = tac.build_case(jfluid, key, case)[0]
    tmain = tac.build_case(fluid, key, case)[0]
    assert tser.program_to_dict(tmain) == jser.program_to_dict(jmain)
    want = tac.run_case(jfluid, jfluid.Executor(), key, case)
    got = tac.run_case(fluid, fluid.Executor(fluid.CPUPlace()), key, case)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].shape == want[name].shape, name
        np.testing.assert_allclose(got[name], want[name], rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    assert any(n.startswith('d') for n in want)


def test_hard_sigmoid_default_slope_tie_parts_from_xla_fma():
    """At the default slope 0.2, x = -2.5 (the case above takes -3.0 in its
    place): the port rounds 0.2f * -2.5 and then the sum, gets 0 exactly
    and splits the tie's gradient (0.1 x ct); XLA's CPU backend fuses the
    two into one FMA, gets -7.45e-9, below the bound, and gradient 0. Both
    outputs are 0 there; every other point holds within rtol 1e-6 and
    atol 1e-6."""
    x = tac._act_input('hard_sigmoid')
    at = x == -2.5
    assert at.sum() == 1
    case = (tac._act('hard_sigmoid'), {'x': x}, ['x'])
    key = 'hard_sigmoid:fma'
    ct = tac.build_case(fluid, key, case)[4]['ct']
    want = tac.run_case(jfluid, jfluid.Executor(), key, case)
    got = tac.run_case(fluid, fluid.Executor(fluid.CPUPlace()), key, case)
    assert got['Out'][at] == 0 and want['Out'][at] == 0
    assert want['dx'][at] == 0
    np.testing.assert_allclose(got['dx'][at], 0.1 * ct[at], rtol=1e-6)
    for name in ('Out', 'dx'):
        np.testing.assert_allclose(got[name][~at], want[name][~at],
                                   rtol=1e-6, atol=1e-6, err_msg=name)
