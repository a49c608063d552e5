"""The recorded op cases (``optest_cases/``, 480 pickles: 275 forward
cases and 205 gradient cases) replayed through the PyTorch port on the CPU.

Each case holds a program, its feeds, its state and the JAX package's CPU
fetches. The program is carried across by the JAX package's
``program_to_dict`` and the port's ``program_from_dict`` (one shared
format), run by the port's ``Executor.run`` and each fetch held to the
recorded one under the corpus's rule (tools/tpu_optest.py, constants in
TPU_OPTEST.json): |got - cpu| <= loosen * (1e-4 + 1e-3 |cpu|), ``loosen``
the largest per-op factor over the case's op types; shapes equal, dtype
kinds equal (x64 off on the JAX side: an int64 fetch was recorded as
int32). A case is skipped, with its reason, only for an op type the port
does not register, an op that draws from the JAX key stream, or a case
tools/tpu_optest.py cannot replay either. The replay's loader
(tools/torch_optest.py), which chip_smoke.py's phase 23 runs on the card
without the JAX package, reads every case's program as the JAX package
writes it.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_optest_replay.py -q
"""
import os
import pickle
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from paddle_tpu.core import registry as jax_registry  # noqa: E402
from paddle_tpu.core.serialization import program_to_dict  # noqa: E402
from paddle_tpu_torch.core.registry import all_ops  # noqa: E402
from tools import torch_optest, tpu_optest  # noqa: E402

CASES = [os.path.basename(p) for p in torch_optest.case_paths()]


@pytest.fixture(scope='module')
def rule():
    return torch_optest.constants()


def test_the_corpus_and_its_rule():
    """480 cases, 275 forward and 205 gradient; the rule's constants are
    tools/tpu_optest.py's; the random ops are the JAX package's needs_rng
    registrations of ops/random_ops.py and sampling_id."""
    assert len(CASES) == 480
    assert sum(n.startswith('gradcase_') for n in CASES) == 205
    rtol, atol, loosen = torch_optest.constants()
    assert (rtol, atol) == (tpu_optest.RTOL, tpu_optest.ATOL)
    assert loosen == tpu_optest.PER_OP_LOOSEN
    import paddle_tpu.ops.random_ops  # noqa: F401  (registers them)
    drawing = {t for t in jax_registry.all_ops()
               if jax_registry.get_op(t).lower.__module__ ==
               'paddle_tpu.ops.random_ops' and
               jax_registry.get_op(t).needs_rng}
    assert torch_optest.RNG_OPS == drawing | {'sampling_id'}


@pytest.mark.parametrize('name', CASES)
def test_recorded_case_on_the_port(name, rule):
    path = os.path.join(torch_optest.CASE_DIR, name)
    with open(path, 'rb') as f:
        case = pickle.load(f)
    pdict = program_to_dict(case['program'])
    # the loader that runs without the JAX package reads the same program
    assert torch_optest.program_dict(
        torch_optest.load_case(path)['program']) == pdict
    why = torch_optest.skip_reason(case, pdict, all_ops())
    if not tpu_optest._replayable(case):
        assert why is not None
    if why:
        pytest.skip(why)
    got = torch_optest.run_case(case, pdict, 'cpu')
    ok, rows = torch_optest.compare(case, got, *rule)
    assert ok, rows
