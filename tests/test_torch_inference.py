"""The deploy path of paddle_tpu_torch (`Program._prune`,
`io.save_inference_model`, `io.load_inference_model`, `PredictorConfig`,
`Predictor`, `create_predictor`) against the JAX package, on the CPU.

Two models, as the bench's `_bench_inference` builds them at a small
size: the cifar10 ResNet of depth 8 (built without ``is_test``, so only
the export's ``clone(for_test=True)`` puts its batch norms on the moving
statistics, which are set to seeded values before the export), and a
2-layer BERT (V 128, L 16, d 64, 4 heads, 4 masked positions) built with
``is_test=True``. Every input comes from a numpy seed.

(a) For the same program built by each package (with ``SGD`` or ``Adam``
    appended, so that the export strips a backward and an optimizer):
    `Program._prune` to the targets and the saved ``__model__`` equal the
    JAX package's, and the saved ``__params__.npz`` holds the same names.
(b) An artifact saved by the JAX package's `save_inference_model` serves
    in the port's ``create_predictor(PredictorConfig(d,
    place=CPUPlace()))``, and one saved by the port serves in the JAX
    package's ``create_predictor``: on the same artifact the two
    predictors' outputs agree within 1e-5 of their largest magnitude.
(c) The predictor's contracts (tests/test_serialization.py:65,
    tests/test_serving.py:252): dict and positional feeds, two predictors
    side by side, a missing or unexpected feed name raises KeyError naming
    it, a wrong count ValueError; ``return_numpy=False`` gives tensors;
    the parameters enter the predictor's scope once (a second call finds
    the same tensors there); `Executor.run_fused` of the predictor's
    program equals its calls; without a place it runs on the card and so
    raises here; the StableHLO pair raises NotImplementedError.
"""
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import goodput, monitor
from paddle_tpu.core import serialization as jser
from paddle_tpu.models import bert as jbert
from paddle_tpu.models import resnet as jresnet

import paddle_tpu_torch as fluid
from paddle_tpu_torch.core import serialization as tser
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import resnet as tresnet

CPU = fluid.CPUPlace()
BERT = dict(vocab_size=128, seq_len=16, d_model=64, n_head=4, n_layer=2,
            d_ff=128, max_predictions=4)
BERT_FEEDS = ['tokens', 'segments', 'input_mask', 'mlm_positions',
              'mlm_labels', 'nsp_labels']


@pytest.fixture(scope='module', autouse=True)
def _fresh_goodput_window():
    """Driving the JAX executor arms the process-wide goodput sentinels;
    restart the window after this module."""
    yield
    goodput.reset()
    # the monitor keeps at most 64 series a metric: leave it empty
    monitor.reset()


def _build(pkg, model, opt=False):
    """(main, startup, feed names, targets) of ``model`` ('resnet' or
    'bert') in ``pkg``, as `_bench_inference` builds it; ``opt`` appends
    an optimizer (SGD for ResNet, Adam for BERT)."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        if model == 'resnet':
            rmod = jresnet if pkg is jfluid else tresnet
            _, _, pred, avg, _ = rmod.build('cifar10', depth=8)
            feeds, targets, loss = ['img'], [pred], avg
        else:
            bmod = jbert if pkg is jfluid else tbert
            losses = bmod.build_bert_pretrain(bmod.BertConfig(**BERT),
                                              is_test=not opt)
            feeds, targets, loss = BERT_FEEDS, list(losses), losses[0]
        if opt:
            (pkg.optimizer.SGD(0.01) if model == 'resnet' else
             pkg.optimizer.Adam(1e-3, fuse=True)).minimize(loss)
    return main, startup, feeds, targets


def _feed(model, batch=3, seed=0):
    rs = np.random.RandomState(seed)
    if model == 'resnet':
        return {'img': rs.randn(batch, 3, 32, 32).astype('float32')}
    f = jbert.make_pretrain_batch(jbert.BertConfig(**BERT), batch, rs)
    f['input_mask'][0, 9:] = 0.0
    return f


def _save(pkg, model, dirname, opt=False):
    """Build ``model`` in ``pkg``, run its startup program, set batch
    norm's moving statistics to seeded values and save the inference
    model under ``dirname``. Returns the main program."""
    main, startup, feeds, targets = _build(pkg, model, opt)
    exe = pkg.Executor(CPU) if pkg is fluid else pkg.Executor()
    scope = pkg.Scope()
    with pkg.scope_guard(scope):
        exe.run(startup, scope=scope)
        rs = np.random.RandomState(11)
        for v in main.list_vars():
            if v.name.endswith('.mean'):
                scope.set(v.name, rs.randn(*v.shape).astype('float32'))
            elif v.name.endswith('.variance'):
                scope.set(v.name, (0.5 + rs.rand(*v.shape))
                          .astype('float32'))
        pkg.io.save_inference_model(dirname, feeds, targets, exe,
                                    main_program=main)
    return main


def _close(got, want, tol=1e-5):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype
        assert np.isfinite(w).all()
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= tol * scale


# ---------------------------------------------------------------------------
# (a) the pruned program and the artifact


@pytest.mark.parametrize('model', ['resnet', 'bert'])
def test_prune_and_saved_model_equal_the_jax_package(model, tmp_path):
    jmain, _, _, jtargets = _build(jfluid, model, opt=True)
    tmain, _, _, ttargets = _build(fluid, model, opt=True)
    names = [t.name for t in ttargets]
    assert names == [t.name for t in jtargets]
    jpruned, tpruned = jmain._prune(names), tmain._prune(names)
    assert tser.program_to_dict(tpruned) == jser.program_to_dict(jpruned)
    assert tpruned._uid != tmain._uid and len(tpruned.global_block().ops) < \
        len(tmain.global_block().ops)

    dirs = {}
    for pkg in (jfluid, fluid):
        d = dirs[pkg] = str(tmp_path / pkg.__name__)
        _save(pkg, model, d, opt=True)
    blobs = {}
    for pkg, d in dirs.items():
        with open(os.path.join(d, '__model__')) as f:
            blobs[pkg] = json.load(f)
        with np.load(os.path.join(d, '__params__.npz')) as data:
            blobs[pkg, 'params'] = sorted(data.files)
    assert blobs[fluid] == blobs[jfluid]
    assert blobs[fluid, 'params'] == blobs[jfluid, 'params']
    ops = blobs[fluid]['blocks'][0]['ops']
    assert not any(op['type'] in ('backward', 'sgd', 'fused_adam')
                   for op in ops)
    if model == 'resnet':
        # the export put every batch norm on its moving statistics, and
        # carries them
        bns = [op for op in ops if op['type'] == 'batch_norm']
        assert len(bns) == 9 and all(op['attrs']['is_test'] for op in bns)
        assert sum(n.endswith(('.mean', '.variance'))
                   for n in blobs[fluid, 'params']) == 18


# ---------------------------------------------------------------------------
# (b) artifacts across the packages


@pytest.fixture(scope='module')
def artifacts(tmp_path_factory):
    """{(saving package, model): model directory}."""
    out = {}
    for pkg in (jfluid, fluid):
        for model in ('resnet', 'bert'):
            d = str(tmp_path_factory.mktemp('%s_%s' % (pkg.__name__, model)))
            _save(pkg, model, d)
            out[pkg, model] = d
    return out


@pytest.mark.parametrize('saved_by', ['jax', 'port'])
@pytest.mark.parametrize('model', ['resnet', 'bert'])
def test_an_artifact_serves_in_both_packages(artifacts, saved_by, model):
    d = artifacts[jfluid if saved_by == 'jax' else fluid, model]
    jpred = jfluid.create_predictor(jfluid.PredictorConfig(model_dir=d))
    tpred = fluid.create_predictor(fluid.PredictorConfig(d, place=CPU))
    assert tpred.get_input_names() == jpred.get_input_names()
    assert tpred.get_output_names() == jpred.get_output_names()
    feed = _feed(model)
    got = tpred.run(feed)
    _close(got, jpred.run(feed))
    if model == 'resnet':
        # the moving statistics were read: the training-mode forward of
        # the same weights differs
        assert got[0].shape == (3, 10)
        assert tpred.program.global_block().ops[1].attr('is_test')


# ---------------------------------------------------------------------------
# (c) the predictor's contracts


def test_predictor_feeds_scopes_and_errors(artifacts):
    d = artifacts[fluid, 'bert']
    pred = fluid.create_predictor(fluid.PredictorConfig(d, place=CPU))
    feed = _feed('bert', batch=2, seed=4)
    want = pred.run(feed)
    assert [w.shape for w in want] == [(1,)] * 3
    # positional feeds, in get_input_names() order
    got = pred.run([feed[n] for n in pred.get_input_names()])
    _close(got, want, tol=0)
    # a second predictor on the same model does not disturb the first
    pred2 = fluid.Predictor(fluid.PredictorConfig(d, place=CPU))
    _close(pred2.run(feed), want, tol=0)
    _close(pred.run(feed), want, tol=0)
    with pytest.raises(KeyError, match="missing \\['tokens'\\]"):
        pred.run({k: v for k, v in feed.items() if k != 'tokens'})
    with pytest.raises(KeyError, match="unexpected \\['extra'\\]"):
        pred.run(dict(feed, extra=feed['tokens']))
    with pytest.raises(ValueError, match='expected 6 inputs'):
        pred.run([feed['tokens']])
    out = pred.run(feed, return_numpy=False)
    assert all(isinstance(o, torch.Tensor) for o in out)
    _close([o.numpy() for o in out], want, tol=0)


def test_parameters_enter_the_scope_once_and_run_fused_matches(artifacts):
    pred = fluid.create_predictor(
        fluid.PredictorConfig(artifacts[fluid, 'resnet'], place=CPU))
    names = pred.scope.names()
    assert all(isinstance(pred.scope.get(n), np.ndarray) for n in names)
    feeds = [_feed('resnet', batch=2, seed=s) for s in (5, 6)]
    first = pred.run(feeds[0])
    held = {n: pred.scope.get(n) for n in names}
    assert all(isinstance(t, torch.Tensor) for t in held.values())
    second = pred.run(feeds[1])
    assert all(pred.scope.get(n) is held[n] for n in names)
    with fluid.scope_guard(pred.scope):
        fused = pred.executor.run_fused(
            pred.program, {'img': np.stack([f['img'] for f in feeds])},
            fetch_list=pred.fetch_vars)
    _close(fused, second, tol=0)
    assert not np.array_equal(first[0], second[0])


def test_predictor_without_a_place_runs_on_the_card(artifacts):
    if torch.cuda.is_available():
        pytest.skip('a card is present: the default place is usable')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fluid.create_predictor(artifacts[fluid, 'resnet'])


@pytest.mark.parametrize('fn', ['export_stablehlo_model',
                                'load_stablehlo_model'])
def test_stablehlo_pair_raises(fn):
    with pytest.raises(NotImplementedError, match='Queue 1 item 7'):
        getattr(fluid.io, fn)('unused')
