"""The inference predictor: a saved model as a callable.

The port's own copy of paddle_tpu/inference.py: ``PredictorConfig``,
``Predictor`` and ``create_predictor``. A `Predictor` owns a private
`Scope` and an `Executor`, loads what `io.save_inference_model` (of either
package) wrote into that scope, and runs the pruned program on each call.
The parameters stay on the device across calls: the first call copies
them there and the executor caches the device copies back into the
predictor's scope (`Executor._state_value`), so a later call moves only
its feed and its fetches. `executor.run_fused(predictor.program, ...)`
under ``scope_guard(predictor.scope)`` replays the same program as a CUDA
graph (the bench's device-resident rate).

The one addition to the reference is ``PredictorConfig(place=)``: None (or
a ``CUDAPlace``) runs on the card, ``CPUPlace()`` on the CPU, as
``Executor(place)`` does. Each call counts ``predictor_run_total`` and
runs in a ``predictor.run`` span (monitor.py), which separate serving
traffic from training runs in the same process; the executor's own run
series count beneath them.
"""
from . import io as _io
from . import monitor
from .executor import Executor, Scope, scope_guard

__all__ = ['PredictorConfig', 'Predictor', 'create_predictor']


class PredictorConfig(object):
    """Where the model lies (``model_dir`` and, when not the defaults, its
    file names) and the ``place`` to run it on (None: the card)."""

    def __init__(self, model_dir=None, model_filename=None,
                 params_filename=None, place=None):
        self.model_dir = model_dir
        self.model_filename = model_filename
        self.params_filename = params_filename
        self.place = place


class Predictor(object):
    """A loaded inference model; ``config`` is a `PredictorConfig` or a
    model directory."""

    def __init__(self, config):
        if isinstance(config, str):
            config = PredictorConfig(model_dir=config)
        self.config = config
        self.scope = Scope()
        self.executor = Executor(config.place)
        with scope_guard(self.scope):
            prog, feed_names, fetch_vars = _io.load_inference_model(
                config.model_dir, self.executor,
                model_filename=config.model_filename,
                params_filename=config.params_filename)
        self.program = prog
        self.feed_names = list(feed_names)
        self.fetch_vars = fetch_vars

    def get_input_names(self):
        return list(self.feed_names)

    def get_output_names(self):
        return [v.name for v in self.fetch_vars]

    def run(self, feed, return_numpy=True, donate=None):
        """Run the model once. ``feed`` is a dict {name: array or tensor},
        or a list in `get_input_names` order (a wrong count raises
        ValueError); a missing or unexpected name raises KeyError naming
        them. Returns the fetches in order as numpy arrays, or with
        ``return_numpy=False`` as tensors on the device. ``donate`` is
        taken for parity with the JAX predictor and changes nothing."""
        if not isinstance(feed, dict):
            arrays = list(feed)
            if len(arrays) != len(self.feed_names):
                raise ValueError(
                    "expected %d inputs %s, got %d"
                    % (len(self.feed_names), self.feed_names, len(arrays)))
            feed = dict(zip(self.feed_names, arrays))
        missing = sorted(n for n in self.feed_names if n not in feed)
        extra = sorted(k for k in feed if k not in self.feed_names)
        if missing or extra:
            raise KeyError(
                "Predictor.run feed does not match get_input_names() %s:%s%s"
                % (self.feed_names,
                   ' missing %s' % missing if missing else '',
                   ' unexpected %s' % extra if extra else ''))
        monitor.inc('predictor_run_total')
        with monitor.span('predictor.run'):
            return self.executor.run(self.program, feed=feed,
                                     fetch_list=self.fetch_vars,
                                     scope=self.scope,
                                     return_numpy=return_numpy)


def create_predictor(config):
    return Predictor(config)
