"""The ``FLAGS_*`` flag tier: ``get_flags`` and ``set_flags``.

The port's own copy of paddle_tpu/flags.py: the same names, types, the
values read from ``FLAGS_<name>`` environment variables at import, and a
``set_flags`` that rolls every flag back when a side effect fails. What
each flag does on the card:

- ``FLAGS_check_nan_inf``: every ``Executor.run``, ``bind`` call and
  ``run_fused`` call checks its fetches and the state it wrote for NaN or
  Inf at the program boundary and raises RuntimeError naming the
  variables (executor.py `check_nan_inf`); under a CUDA graph the check
  is part of the graph, one flag tensor a variable, read with the fetches.
- ``FLAGS_debug_nans``: ``Executor.run`` runs under
  ``torch.autograd.detect_anomaly(check_nan=True)``, which raises at the
  backward function that returned a NaN. Anomaly mode reads each
  gradient on the host, which a CUDA graph capture cannot do: a ``bind``
  or ``run_fused`` on the card raises RuntimeError saying so while the
  flag is on (on the CPU, where a bound plan runs eagerly, it holds).
- ``FLAGS_deterministic_compile``: ``torch.use_deterministic_algorithms``
  with TF32 off for cuBLAS and cuDNN (and ``CUBLAS_WORKSPACE_CONFIG`` set
  where unset, as deterministic cuBLAS needs): the card's counterpart of
  pinning XLA's matmul precision. Off again, deterministic algorithms are
  off; TF32 stays off, the port's default.
- ``FLAGS_benchmark``: ``Executor.run`` synchronizes the device after the
  run and observes ``executor_sync_seconds``.
- ``FLAGS_monitor_log``: the path of the monitor's JSON-lines snapshots
  (``monitor.configure_logging``); this module is the one place that
  configures it. A path that cannot be written at import warns and
  clears the flag; through ``set_flags`` it raises and rolls back.
- ``FLAGS_cpu_deterministic``, ``FLAGS_eager_delete_tensor_gb``,
  ``FLAGS_paddle_num_threads``, ``FLAGS_barrier_deadline_secs`` and
  ``FLAGS_rendezvous_deadline_secs``: accepted for parity, as in the
  reference.
"""
import os

__all__ = ['get_flags', 'set_flags']

_BOOL = ('check_nan_inf', 'debug_nans', 'cpu_deterministic', 'benchmark',
         'deterministic_compile')
_FLOAT = ('eager_delete_tensor_gb', 'barrier_deadline_secs',
          'rendezvous_deadline_secs')
_INT = ('paddle_num_threads',)
_STR = ('monitor_log',)

_flags = {}


def _parse_bool(s):
    return str(s).strip().lower() in ('1', 'true', 'yes', 'on')


def _load_env():
    for name in _BOOL:
        v = os.environ.get('FLAGS_' + name)
        _flags[name] = _parse_bool(v) if v is not None else False
    for name in _FLOAT:
        v = os.environ.get('FLAGS_' + name)
        _flags[name] = float(v) if v else 0.0
    for name in _INT:
        v = os.environ.get('FLAGS_' + name)
        _flags[name] = int(v) if v else 0
    for name in _STR:
        _flags[name] = os.environ.get('FLAGS_' + name) or ''
    _apply_side_effects(import_time=True)


_det_touched = False
_monitor_log_touched = False


def _set_deterministic(on):
    import torch
    if on:
        os.environ.setdefault('CUBLAS_WORKSPACE_CONFIG', ':4096:8')
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(bool(on))


def _apply_side_effects(import_time=False):
    # deterministic algorithms only where the flag was used: never undo a
    # torch setting made outside this tier
    if _det_touched or 'FLAGS_deterministic_compile' in os.environ:
        _set_deterministic(_flags.get('deterministic_compile'))
    if _monitor_log_touched or 'FLAGS_monitor_log' in os.environ:
        from . import monitor
        try:
            monitor.configure_logging(_flags.get('monitor_log') or None)
        except OSError:
            if not import_time:
                raise
            # a stale FLAGS_monitor_log must not make the import fail:
            # warn, log nothing, and clear the flag (or every later
            # set_flags would try the bad path again)
            import warnings
            warnings.warn(
                "FLAGS_monitor_log=%r is not writable; monitor logging "
                "disabled" % _flags.get('monitor_log'), stacklevel=2)
            _flags['monitor_log'] = ''


def get_flags(name=None):
    """Value of one flag (with or without the ``FLAGS_`` prefix), or a
    copy of the whole flag dict."""
    if name is None:
        return dict(_flags)
    name = name[6:] if name.startswith('FLAGS_') else name
    if name not in _flags:
        raise KeyError("unknown flag %r (known: %s)"
                       % (name, sorted(_flags)))
    return _flags[name]


def set_flags(flags_or_name, value=None):
    """``set_flags({'FLAGS_check_nan_inf': True})`` or
    ``set_flags('check_nan_inf', True)``. A failed side effect (an
    unwritable ``monitor_log``) restores every flag and raises."""
    if isinstance(flags_or_name, dict):
        items = flags_or_name.items()
    else:
        items = [(flags_or_name, value)]
    global _det_touched, _monitor_log_touched
    old = dict(_flags)
    for name, v in items:
        name = name[6:] if name.startswith('FLAGS_') else name
        if name not in _flags:
            raise KeyError("unknown flag %r (known: %s)"
                           % (name, sorted(_flags)))
        if name in _BOOL:
            v = _parse_bool(v) if not isinstance(v, bool) else v
        if name in _STR:
            v = '' if v is None else str(v)
        if name == 'deterministic_compile':
            _det_touched = True
        if name == 'monitor_log':
            _monitor_log_touched = True
        _flags[name] = v
    try:
        _apply_side_effects()
    except Exception:
        _flags.clear()
        _flags.update(old)
        try:
            _apply_side_effects()
        except Exception:
            pass                        # the original error wins
        raise


_load_env()
