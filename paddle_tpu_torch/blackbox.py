"""Incident flight recorder: black-box debug bundles for every detector.

The port's own copy of paddle_tpu/blackbox.py, over the port's monitor,
trace, goodput and analysis: the same knobs, triggers, bundle layout,
writer thread, rate limit and rotation. ``env.json`` records torch, CUDA
and the card's name in place of the JAX versions; ``analysis.json`` holds
the port's record (analysis.py); ``replay/`` holds the feed and the
pre-step state as ``.npz`` and the run's seed. ``program.hlo`` has no
counterpart on the card and is left out. ``python tools/torch_blackbox.py
replay <bundle>`` re-executes a captured step through the port's NaN
localization (analysis.py).

The JAX package detects trouble everywhere — ``perf_regression_total{kind}``
sentinel trips, NaN escalation with localization, retry give-ups, worker
death / elastic resumes, serving and decode step failures, PS transport
give-ups (which surface as ``retry_giveup`` at the ``ps_pull`` /
``ps_push`` sites) — but until now the evidence died with the process:
the monitor snapshot, trace ring, goodput ledger, and the implicated
program's cost analysis are all in-memory. This module is the flight
recorder: when any detector fires, it atomically publishes a
self-contained post-mortem bundle an engineer can inspect offline and
**replay** (in the JAX package, ``python tools/blackbox.py replay
<bundle>`` re-executes the captured step through the NaN-localize
machinery).

Bundle layout (one directory per incident, tmp -> rename atomic)::

    <dir>/bundle_<kind>_<millis>_<pid>_<n>/
        manifest.json     trigger kind/fields, wall, step, rank, rng,
                          embedded NaN localization, file inventory
        monitor.json      full monitor.snapshot()
        metrics.prom      Prometheus text exposition
        trace.json        span ring as chrome://tracing JSON
        traces.jsonl      finished trace records (keep-errors included)
        goodput.json      goodput.stats(): accounting + the regression
                          log with tripped-baseline context
        env.json          PADDLE_*/FLAGS_*/CUDA knobs + torch, CUDA and
                          the card's name
        program.json      the implicated Program (durable serialization)
        analysis.json     the port's registered cost analysis for it
        replay/           feed + pre-step state arrays + the run's seed

Hot-path contract: the un-triggered path costs one cached env read
(``enabled()`` — same idiom as goodput's kill switch; the executor's
``note_step`` hook is guard-tested <= 5 us). ``record()`` itself is
rate-limit check + deque append; every heavy capture (snapshot, chrome
trace, serialization, npz writes) happens on a daemon writer thread, off
the step path, and NEVER raises into training — failures warn and count
``blackbox_write_errors_total`` (the "RPO degrades loudly" idiom).

Knobs: ``PADDLE_BLACKBOX=1`` enables; ``PADDLE_BLACKBOX_DIR`` (default
``./blackbox``) is the bundle root (rank-suffixed under
``distributed.launch``, restart-suffixed across elastic incarnations);
``PADDLE_BLACKBOX_KEEP`` (default 8) keep-last-N rotation;
``PADDLE_BLACKBOX_RATE`` (default 60) per-kind seconds between bundles.
Guide:
docs/observability.md "Incident flight recorder".
"""
import collections
import itertools
import json
import os
import shutil
import sys
import threading
import time
import warnings

from . import monitor
from . import trace as trace_mod

__all__ = ['enabled', 'record', 'note_step', 'flush', 'reset', 'bundles',
           'bundle_dir', 'last_write_ms', 'TRIGGER_KINDS']

# trigger catalog (docs/observability.md): every kind record() is called
# with by the wired detectors. tools/blackbox.py prints this; the doc
# lint cross-checks the docs list against it.
TRIGGER_KINDS = {
    'step_drift': 'goodput sentinel: per-step execute EWMA over baseline',
    'recompile_storm': 'goodput sentinel: compile burst after steady state',
    'accept_collapse': 'goodput sentinel: speculative accept-rate collapse',
    'queue_burn': 'goodput sentinel: queue-wait EWMA past the SLO',
    'bench_row_drift': 'goodput sentinel: bench row below its committed '
                       'baseline (note_bench_row)',
    'retry_giveup': 'resilience: a retry site exhausted its policy '
                    '(includes ps_pull/ps_push transport give-ups)',
    'nonfinite_escalate': 'TrainingGuard escalation — carries the NaN '
                          'localization and the replayable step',
    'training_anomaly': 'health detector bank: confirmed training-dynamics '
                        'anomaly (grad explosion/vanish, loss spike, '
                        'update-ratio drift, non-finite grads) — bundle '
                        'carries the per-layer stat table and the '
                        'last-N-step history ring',
    'elastic_resume': 'elastic_train_loop survived a failure and resumed',
    'elastic_giveup': 'elastic_train_loop exhausted its resume budget',
    'elastic_grow': 'elastic grow-back: preempted capacity returned and '
                    'the run re-expanded onto the larger mesh',
    'ps_restore_fallback': 'CheckpointManager: a dense checkpoint '
                           'restored but its paired PS fleet dump was '
                           'missing/corrupt — fell back to an older pair',
    'worker_failed': 'distributed.launch: a worker rank died',
    'serving_batch_error': 'ServingEngine: a dispatched batch failed',
    'generate_step_error': 'GenerateEngine: a decode step failed its '
                           'residents',
    'fleet_slo_burn': 'fleet Router: a tenant queue-wait EWMA burned '
                      'past its SLO, or sheds stormed — bundle carries '
                      'every tenant\'s queue state',
    'deploy_failed': 'ModelFleet.deploy: loading/warming a new artifact '
                     'failed before the traffic flip (old version kept '
                     'serving)',
}

_DEFAULT_KEEP = 8
_DEFAULT_RATE_S = 60.0

# cached env flag (the goodput enabled() idiom): the per-call cost of the
# un-triggered path is one env read + one compare
_on_cache = ['\0', False]


def enabled():
    """PADDLE_BLACKBOX=1 turns the recorder on (default off: tier-1 test
    runs inject faults on purpose and must not shed bundles)."""
    s = os.environ.get('PADDLE_BLACKBOX', '')
    if s != _on_cache[0]:
        _on_cache[0] = s
        _on_cache[1] = s not in ('', '0', 'off', 'false')
    return _on_cache[1]


def bundle_dir():
    """Bundle root for this process (PADDLE_BLACKBOX_DIR, default
    ./blackbox). distributed.launch rank-suffixes it per worker and
    run_elastic restart-suffixes it per incarnation, so one fleet/job
    never interleaves two processes' rotation windows."""
    return os.environ.get('PADDLE_BLACKBOX_DIR', '') or 'blackbox'


def _env_float(name, default):
    try:
        return float(os.environ.get(name, '') or default)
    except ValueError:
        return default


def _keep():
    return max(1, int(_env_float('PADDLE_BLACKBOX_KEEP', _DEFAULT_KEEP)))


def _rate_s():
    return _env_float('PADDLE_BLACKBOX_RATE', _DEFAULT_RATE_S)


# ---------------------------------------------------------------------------
# state

_q = collections.deque()
_evt = threading.Event()
_thread = [None]
_busy = [0]                     # bundles mid-write (flush() waits on it)
_rate_last = {}                 # kind -> perf time of the last accepted
_seq = itertools.count(1)
_last_step = [None, None]       # [fingerprint, program] from note_step
_last_write_ms = [None]
_atexit_hooked = [False]


def note_step(program):
    """Executor hot-path hook: remember the last dispatched program so a
    bundle with no explicit program context (sentinel trips, retry
    give-ups) can still name + analyze the implicated signature. One
    cached env read when disabled; one slot write when on (<= 5 us,
    guard-tested by tests/test_blackbox.py). Fingerprint/serialization
    happen at bundle-write time, never here."""
    if not enabled():
        return
    _last_step[1] = program


def last_write_ms():
    """Wall milliseconds the most recent bundle took to build+publish
    (None before the first) — chaosbench reports it on the perf record."""
    return _last_write_ms[0]


def record(kind, error=None, program=None, feed=None, state=None,
           lods=None, key_arr=None, localization=None, step=None,
           **fields):
    """One detector firing. Cheap and lock-friendly: a per-kind rate
    check and a deque append — callers may hold their own locks (the
    goodput sentinel fires under its accounting lock). The writer thread
    does every heavy capture. Returns True when a bundle was enqueued,
    False when disabled or rate-limited."""
    if not enabled():
        return False
    now = time.perf_counter()
    last = _rate_last.get(kind)
    if last is not None and now - last < _rate_s():
        monitor.inc('blackbox_rate_limited_total', labels={'kind': kind})
        return False
    _rate_last[kind] = now
    tr = None
    try:
        tr = trace_mod.current()
    except Exception:           # noqa: BLE001 — telemetry only
        pass
    item = {
        'kind': kind,
        'ts': time.time(),
        'fields': dict(fields),
        'error': error if error is None or isinstance(error, str)
        else '%s: %s' % (type(error).__name__, error),
        'program': program,
        'feed': feed,
        'state': state,
        'lods': lods,
        'key_arr': key_arr,
        'localization': localization,
        'step': step,
        'trace_id': tr.trace_id if tr is not None else None,
        'dir': bundle_dir(),
    }
    _q.append(item)
    _ensure_thread()
    _evt.set()
    return True


# ---------------------------------------------------------------------------
# writer thread


def _ensure_thread():
    t = _thread[0]
    if t is None or not t.is_alive():
        t = threading.Thread(target=_writer_loop, name='paddle-blackbox',
                             daemon=True)
        _thread[0] = t
        t.start()
    if not _atexit_hooked[0]:
        # an escalation usually unwinds the process right after record():
        # without this, the daemon writer dies mid-bundle with it
        _atexit_hooked[0] = True
        import atexit
        atexit.register(flush, 10.0)


def _writer_loop():
    while True:
        _evt.wait(0.2)
        _evt.clear()
        while _q:
            try:
                item = _q.popleft()
            except IndexError:
                break
            _busy[0] += 1
            try:
                _write_bundle(item)
            except Exception as e:      # noqa: BLE001 — never into training
                monitor.inc('blackbox_write_errors_total')
                warnings.warn('blackbox: bundle write failed (%s: %s); '
                              'the incident is lost but the job lives'
                              % (type(e).__name__, e), stacklevel=2)
            finally:
                _busy[0] -= 1


def flush(timeout_s=10.0):
    """Block until every enqueued bundle is published (tests, atexit,
    chaos drills). Returns True when the queue drained in time."""
    deadline = time.monotonic() + float(timeout_s)
    while _q or _busy[0]:
        t = _thread[0]
        if t is None or not t.is_alive():
            # no writer (it died, or record() was never called after
            # reset): drain inline so atexit still publishes
            while _q:
                item = _q.popleft()
                try:
                    _write_bundle(item)
                except Exception:       # noqa: BLE001
                    monitor.inc('blackbox_write_errors_total')
            break
        _evt.set()
        if time.monotonic() > deadline:
            return False
        time.sleep(0.01)
    return True


def reset():
    """Test isolation: clear the rate limiter, queue, and last-step
    slots. Published bundles stay on disk."""
    _q.clear()
    _rate_last.clear()
    _last_step[0] = _last_step[1] = None
    _last_write_ms[0] = None
    _on_cache[0] = '\0'


# ---------------------------------------------------------------------------
# bundle assembly


def _json_safe(v):
    try:
        json.dumps(v)
        return v
    except (TypeError, ValueError):
        return repr(v)


def _dump_json(path, obj):
    with open(path, 'w') as f:
        json.dump(obj, f, indent=1, sort_keys=True, default=repr)


def _capture_env():
    keep = ('PADDLE_', 'FLAGS_', 'CUDA_', 'TORCH_')
    env = {k: v for k, v in os.environ.items() if k.startswith(keep)}
    info = {'env': env, 'python': sys.version.split()[0],
            'argv': list(sys.argv)}
    try:
        import torch
        info['torch'] = torch.__version__
        info['cuda'] = torch.version.cuda
        if torch.cuda.is_available():
            info['device_kind'] = torch.cuda.get_device_name(0)
            info['device_count'] = torch.cuda.device_count()
    except Exception:           # noqa: BLE001 — capture stays best-effort
        pass
    return info


def _numpy(v):
    """A host copy of a feed or state value (a bf16 tensor as float32:
    numpy has no bf16)."""
    import numpy as np
    if hasattr(v, 'detach'):
        if str(v.dtype) == 'torch.bfloat16':
            v = v.float()
        return v.detach().to('cpu').numpy()
    return np.asarray(v)


def _save_arrays(dirpath, name, arrays):
    """Write a {var_name: array} dict as <name>.npz with positional keys
    plus a name map — var names ('fc_0.w_0', grads with '@') are not
    safe npz member names. Returns (npz_filename, names, skipped)."""
    import numpy as np
    names, payload, skipped = [], {}, []
    for n, v in arrays.items():
        try:
            payload['arr_%d' % len(names)] = _numpy(v)
            names.append(n)
        except Exception:       # noqa: BLE001 — skip the unconvertible
            skipped.append(n)
    path = os.path.join(dirpath, name + '.npz')
    np.savez(path, **payload)
    return name + '.npz', names, skipped


def _capture_program(tmp, program, manifest):
    """program.json + analysis.json: serialize the implicated program and
    attach its registered cost analysis."""
    from . import analysis
    files = []
    fp = None
    try:
        fp = program._fingerprint()
    except Exception:           # noqa: BLE001
        pass
    manifest['fingerprint'] = fp
    try:
        from .core import serialization
        _dump_json(os.path.join(tmp, 'program.json'),
                   serialization.program_to_dict(program))
        files.append('program.json')
    except Exception as e:      # noqa: BLE001 — partial bundles beat none
        manifest.setdefault('capture_errors', []).append(
            'program.json: %s' % e)
    rec = None
    try:
        rec = analysis.lookup(fp if fp else program)
    except Exception:           # noqa: BLE001
        pass
    if rec is not None:
        try:
            _dump_json(os.path.join(tmp, 'analysis.json'), rec.as_dict())
            files.append('analysis.json')
        except Exception as e:  # noqa: BLE001
            manifest.setdefault('capture_errors', []).append(
                'analysis.json: %s' % e)
    return files


def _capture_replay(tmp, item, manifest):
    """replay/: feed + pre-step state arrays + the failed step's run seed
    (``run_key.npy``), as the JAX package lays them out."""
    import numpy as np
    rdir = os.path.join(tmp, 'replay')
    os.makedirs(rdir)
    meta = {'lods': {k: _json_safe(v)
                     for k, v in (item['lods'] or {}).items()}}
    files = []
    if item['feed']:
        fname, names, skipped = _save_arrays(rdir, 'feed', item['feed'])
        meta['feed_names'] = names
        meta['feed_skipped'] = skipped
        files.append('replay/' + fname)
    if item['state']:
        fname, names, skipped = _save_arrays(rdir, 'state', item['state'])
        meta['state_names'] = names
        meta['state_skipped'] = skipped
        files.append('replay/' + fname)
    if item['key_arr'] is not None:
        np.save(os.path.join(rdir, 'run_key.npy'),
                np.asarray(item['key_arr']))
        files.append('replay/run_key.npy')
    _dump_json(os.path.join(rdir, 'replay.json'), meta)
    files.append('replay/replay.json')
    manifest['replayable'] = bool(item['state'] is not None
                                  or item['feed'])
    return files


def _write_bundle(item):
    t_start = time.perf_counter()
    root = item['dir']
    os.makedirs(root, exist_ok=True)
    name = 'bundle_%s_%d_%d_%d' % (item['kind'],
                                   int(item['ts'] * 1e3),
                                   os.getpid(), next(_seq))
    tmp = os.path.join(root, '.tmp.' + name)
    final = os.path.join(root, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        rank = None
        try:
            rank = int(os.environ.get('PADDLE_TRAINER_ID', ''))
        except ValueError:
            pass
        program = item['program']
        if program is None and _last_step[1] is not None:
            program = _last_step[1]
        manifest = {
            'kind': item['kind'],
            'ts': item['ts'],
            'wall': time.strftime('%Y-%m-%dT%H:%M:%S%z',
                                  time.localtime(item['ts'])),
            'step': item['step'],
            'pid': os.getpid(),
            'rank': rank,
            'trace_id': item['trace_id'],
            'error': item['error'],
            'trigger': {k: _json_safe(v)
                        for k, v in item['fields'].items()},
            'localization': item['localization'],
        }
        if program is not None:
            manifest['rng'] = {
                'random_seed': getattr(program, 'random_seed', None),
                'run_counter': getattr(program, '_rng_run_counter', None),
            }
        files = []
        # the always-cheap captures first: even a capture failure further
        # down leaves a useful bundle
        _dump_json(os.path.join(tmp, 'monitor.json'), monitor.snapshot())
        files.append('monitor.json')
        with open(os.path.join(tmp, 'metrics.prom'), 'w') as f:
            f.write(monitor.export_prometheus())
        files.append('metrics.prom')
        try:
            from . import profiler
            profiler.export_chrome_tracing(os.path.join(tmp, 'trace.json'))
            files.append('trace.json')
        except Exception as e:  # noqa: BLE001
            manifest.setdefault('capture_errors', []).append(
                'trace.json: %s' % e)
        with open(os.path.join(tmp, 'traces.jsonl'), 'w') as f:
            for rec in trace_mod.recent():
                f.write(json.dumps(rec, sort_keys=True, default=repr)
                        + '\n')
        files.append('traces.jsonl')
        try:
            from . import goodput
            _dump_json(os.path.join(tmp, 'goodput.json'), goodput.stats())
            files.append('goodput.json')
        except Exception as e:  # noqa: BLE001
            manifest.setdefault('capture_errors', []).append(
                'goodput.json: %s' % e)
        _dump_json(os.path.join(tmp, 'env.json'), _capture_env())
        files.append('env.json')
        if program is not None:
            files.extend(_capture_program(tmp, program, manifest))
        if item['feed'] or item['state'] is not None \
                or item['key_arr'] is not None:
            files.extend(_capture_replay(tmp, item, manifest))
        manifest['files'] = sorted(files)
        _dump_json(os.path.join(tmp, 'manifest.json'), manifest)
        os.rename(tmp, final)       # the atomic publish: all or nothing
        try:
            fd = os.open(root, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        except OSError:         # durability is best-effort
            pass
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _rotate(root)
    dt_ms = (time.perf_counter() - t_start) * 1e3
    _last_write_ms[0] = dt_ms
    monitor.inc('blackbox_bundle_total', labels={'kind': item['kind']})
    monitor.observe('blackbox_write_seconds', dt_ms / 1e3)
    # the bundle pointer: one JSON line on the shared trace/monitor log
    # channel, so a merged rank log names every bundle it references
    # (tools/obsreport.py --bundles / tools/tracereport.py --bundles)
    trace_mod.log_line({
        'blackbox_bundle': final,
        'kind': item['kind'],
        'ts': item['ts'],
        'trace_id': item['trace_id'] or trace_mod.new_trace_id(),
    })
    return final


def _rotate(root):
    """Keep-last-N: oldest published bundles beyond PADDLE_BLACKBOX_KEEP
    are removed (bundle names embed millis + a sequence number, so the
    lexicographic sort of the timestamp field is the publish order)."""
    try:
        entries = [e for e in os.listdir(root)
                   if e.startswith('bundle_')
                   and os.path.isdir(os.path.join(root, e))]
    except OSError:
        return
    if len(entries) <= _keep():
        return
    def _stamp(e):
        parts = e.rsplit('_', 3)
        try:
            return (int(parts[-3]), int(parts[-1]))
        except (ValueError, IndexError):
            return (0, 0)
    entries.sort(key=_stamp)
    for e in entries[:len(entries) - _keep()]:
        shutil.rmtree(os.path.join(root, e), ignore_errors=True)


def bundles(root=None):
    """Published bundle paths under `root` (default this process's
    bundle_dir()), oldest first."""
    root = root or bundle_dir()
    try:
        entries = [e for e in os.listdir(root)
                   if e.startswith('bundle_')
                   and os.path.isdir(os.path.join(root, e))]
    except OSError:
        return []
    def _stamp(e):
        parts = e.rsplit('_', 3)
        try:
            return (int(parts[-3]), int(parts[-1]))
        except (ValueError, IndexError):
            return (0, 0)
    entries.sort(key=_stamp)
    return [os.path.join(root, e) for e in entries]
