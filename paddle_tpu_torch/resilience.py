"""Fault-tolerant runtime layer: fault injection, retry with backoff,
checkpoint-file hardening, and non-finite-step recovery.

The port's own copy of paddle_tpu/resilience.py (all of it but
``elastic_train_loop``, which waits for the port's checkpoint and mesh
modules), over the port's monitor, trace and blackbox:

- **Fault injection** (``PADDLE_FAULT_SPEC``): controlled
  ``InjectedFault`` errors at the ``compile`` site (a run plan's build),
  the ``run`` site (each dispatch: ``Executor.run``, a ``BoundProgram``
  call, each step of ``run_fused``) and ``ckpt_write`` (io.py's
  publication of a file). Grammar (';'-separated clauses)::

      site:trigger[,kind=fatal]
      compile:p=0.5        # each compile fails with probability 0.5
      run:nth=3            # exactly the 3rd run dispatch fails
      run:n=2              # the first 2 dispatches fail (then recover)
      ckpt_write:always    # every checkpoint write fails
      collective:every=4   # every 4th collective boundary fails

  Faults are transient (retryable) unless ``kind=fatal``; the env var is
  re-read at every site check.

- **Retry policy**: exponential backoff, full jitter and a wall-clock
  deadline (``PADDLE_RETRY_MAX_ATTEMPTS``, default 4;
  ``PADDLE_RETRY_BASE_S`` 0.05; ``PADDLE_RETRY_MAX_S`` 2.0;
  ``PADDLE_RETRY_DEADLINE_S`` 30). The taxonomy (`is_transient`) is the
  reference's plus the card's: ``torch.cuda.OutOfMemoryError`` is
  transient (the allocator's cache is emptied first), a sticky CUDA error
  (an illegal address, a launch failure, a device-side assert) is
  permanent, since the context is gone. The reference refuses to retry
  over donated (consumed) buffers; the port's counterpart is its
  in-place state: a run that failed after it wrote any state tensor is
  never re-run (`StateWrites`), because that state is half-updated.

- **Checkpoint-file helpers** (crc32 manifests; tmp + fsync + rename
  writes with the ``ckpt_write`` fault site, and a sweep of dead writers'
  temporary files), used by io.py.

- **TrainingGuard**: a step wrapper that detects a non-finite loss, rolls
  the scope back to the pre-step state, backs off an optional loss scale,
  and escalates to a raise after N consecutive bad steps. The port's
  optimizers update state in place, so the snapshot is a copy of every
  written persistable, and a rollback copies it back into the same
  tensors (a bound graph holds their addresses).

Every recovery event counts a monitor series (``retry_attempt_total
{site}``, ``retry_giveup_total{site}``, ``fault_injected_total{site}``,
``nonfinite_skip_total``, ``nonfinite_escalate_total``,
``health_preempt_rollback_total``); docs/resilience.md is the catalog.
"""
import os
import random
import threading
import time
import zlib

import numpy as np
import torch

from . import blackbox
from . import monitor
from . import trace as trace_mod

__all__ = ['InjectedFault', 'NonFiniteError', 'RetryPolicy', 'TrainingGuard',
           'StateWrites', 'maybe_fault', 'install_fault', 'clear_faults',
           'fault_spec', 'is_transient', 'retry_call', 'retry_after',
           'atomic_file', 'atomic_write_bytes', 'sweep_stale_tmp_files',
           'build_manifest', 'verify_manifest', 'write_manifest',
           'read_manifest', 'array_crc32']


# ---------------------------------------------------------------------------
# fault injection


class InjectedFault(RuntimeError):
    """Controlled fault raised at a runtime boundary by PADDLE_FAULT_SPEC /
    install_fault. Transient by default so the retry layer engages; fatal
    faults (kind=fatal) must propagate un-retried."""

    def __init__(self, site, message, transient=True):
        RuntimeError.__init__(self, message)
        self.site = site
        self.transient = transient


class NonFiniteError(RuntimeError):
    """Raised by TrainingGuard after max_bad_steps consecutive non-finite
    steps — the escalation path when skipping stops being recovery and
    starts being denial."""


class _FaultRule(object):
    __slots__ = ('site', 'mode', 'value', 'fatal', 'calls', 'rng')

    def __init__(self, site, mode, value, fatal):
        self.site = site
        self.mode = mode          # 'always' | 'p' | 'nth' | 'n' | 'every'
        self.value = value
        self.fatal = fatal
        self.calls = 0
        # deterministic per-rule stream: reproducible fault schedules
        # without perturbing global random state
        seed = int(os.environ.get('PADDLE_FAULT_SEED', '0') or 0)
        self.rng = random.Random((zlib.crc32(site.encode()) << 1) ^ seed)

    def fire(self):
        self.calls += 1
        if self.mode == 'always':
            return True
        if self.mode == 'p':
            return self.rng.random() < self.value
        if self.mode == 'nth':
            return self.calls == int(self.value)
        if self.mode == 'n':
            return self.calls <= int(self.value)
        if self.mode == 'every':
            return self.calls % int(self.value) == 0
        return False


def _parse_spec(spec):
    """'compile:p=0.5;run:nth=3,kind=fatal' -> {site: _FaultRule}. Raises
    ValueError on a malformed clause — a typo'd fault spec silently doing
    nothing would defeat the whole point of injecting faults."""
    rules = {}
    for clause in spec.split(';'):
        clause = clause.strip()
        if not clause:
            continue
        if ':' not in clause:
            raise ValueError(
                "PADDLE_FAULT_SPEC clause %r: expected 'site:trigger'"
                % clause)
        site, _, rest = clause.partition(':')
        site = site.strip()
        fatal = False
        mode, value = None, None
        for part in rest.split(','):
            part = part.strip()
            if not part:
                continue
            if part == 'always':
                mode, value = 'always', None
            elif part.startswith('kind='):
                kind = part[5:]
                if kind not in ('transient', 'fatal'):
                    raise ValueError(
                        "PADDLE_FAULT_SPEC site %r: unknown kind=%r "
                        "(transient|fatal)" % (site, kind))
                fatal = kind == 'fatal'
            elif '=' in part:
                k, _, v = part.partition('=')
                if k not in ('p', 'nth', 'n', 'every'):
                    raise ValueError(
                        "PADDLE_FAULT_SPEC site %r: unknown trigger %r "
                        "(always|p=|nth=|n=|every=)" % (site, k))
                try:
                    mode, value = k, float(v)
                except ValueError:
                    raise ValueError(
                        "PADDLE_FAULT_SPEC site %r: non-numeric trigger "
                        "value %r" % (site, v))
                if k != 'p' and value < 1:
                    raise ValueError(
                        "PADDLE_FAULT_SPEC site %r: %s=%s must be >= 1"
                        % (site, k, v))
            else:
                raise ValueError(
                    "PADDLE_FAULT_SPEC site %r: unparseable part %r"
                    % (site, part))
        if mode is None:
            raise ValueError(
                "PADDLE_FAULT_SPEC site %r: no trigger (always|p=|nth=|"
                "n=|every=)" % site)
        rules[site] = _FaultRule(site, mode, value, fatal)
    return rules


_fault_lock = threading.Lock()
_env_rules = (None, {})         # (spec string it was parsed from, rules)
_prog_rules = {}                # install_fault() registrations (tests)


def maybe_fault(site):
    """Raise an InjectedFault at `site` if the active fault spec says so.
    The no-fault fast path is one env read + a falsy check — cheap enough
    for the executor hot path."""
    global _env_rules
    spec = os.environ.get('PADDLE_FAULT_SPEC', '')
    if not spec and not _prog_rules:
        return
    with _fault_lock:
        rule = _prog_rules.get(site)
        if rule is None and spec:
            if _env_rules[0] != spec:
                # counters survive only within one spec string; a changed
                # spec is a new fault schedule
                _env_rules = (spec, _parse_spec(spec))
            rule = _env_rules[1].get(site)
        if rule is None or not rule.fire():
            return
        transient = not rule.fatal
    monitor.inc('fault_injected_total', labels={'site': site})
    raise InjectedFault(
        site, "injected fault at %r (call %d of spec %r)%s"
        % (site, rule.calls, spec or '<install_fault>',
           '' if transient else ' [fatal]'),
        transient=transient)


def install_fault(site, mode='always', value=None, fatal=False):
    """Programmatic fault registration (tests): overrides any
    PADDLE_FAULT_SPEC clause for `site`."""
    with _fault_lock:
        _prog_rules[site] = _FaultRule(site, mode, value, fatal)


def clear_faults():
    """Drop programmatic registrations and the parsed-env cache."""
    global _env_rules
    with _fault_lock:
        _prog_rules.clear()
        _env_rules = (None, {})


class fault_spec(object):
    """Context manager scoping a PADDLE_FAULT_SPEC string to a block::

        with resilience.fault_spec('ckpt_write:always'):
            ...
    """

    def __init__(self, spec):
        self._spec = spec
        self._prev = None

    def __enter__(self):
        self._prev = os.environ.get('PADDLE_FAULT_SPEC')
        os.environ['PADDLE_FAULT_SPEC'] = self._spec
        return self

    def __exit__(self, *exc):
        if self._prev is None:
            os.environ.pop('PADDLE_FAULT_SPEC', None)
        else:
            os.environ['PADDLE_FAULT_SPEC'] = self._prev
        clear_faults()
        return False


# ---------------------------------------------------------------------------
# transient-error taxonomy + retry policy


# substrings marking an error worth retrying: the status codes a transient
# infrastructure failure surfaces as (TF's retry taxonomy), plus
# socket-level connect noise
_TRANSIENT_MARKERS = (
    'RESOURCE_EXHAUSTED', 'UNAVAILABLE', 'DEADLINE_EXCEEDED', 'ABORTED',
    'CANCELLED', 'connection reset', 'connection refused', 'broken pipe',
    'socket closed', 'failed to connect', 'transient',
)

# a CUDA error that leaves the context unusable: nothing on this process
# can run on the card after it, so no retry can succeed
_STICKY_CUDA_MARKERS = (
    'illegal memory access', 'illegal address', 'unspecified launch failure',
    'illegal instruction', 'misaligned address', 'device-side assert',
    'launch timed out', 'hardware stack error', 'uncorrectable ecc',
    'cudaerrorlaunchfailure', 'cudaerrorillegaladdress',
)


def is_transient(exc):
    """Is `exc` worth retrying? InjectedFault carries its own flag; a CUDA
    out-of-memory error is transient (the allocator's cached blocks are
    released first, so the retry sees the memory other steps freed); a
    sticky CUDA error is permanent; connection-level OSErrors and
    status-code-bearing messages match the marker list; everything else
    (shape errors, user bugs) is permanent."""
    if isinstance(exc, InjectedFault):
        return exc.transient
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        return True
    msg = str(exc).lower()
    if any(m in msg for m in _STICKY_CUDA_MARKERS):
        return False
    if isinstance(exc, (ConnectionError, TimeoutError)):
        return True
    return any(m.lower() in msg for m in _TRANSIENT_MARKERS)


def _env_float(name, default):
    try:
        return float(os.environ.get(name, '') or default)
    except ValueError:
        return default


class StateWrites(object):
    """Whether a failed run wrote state in place (the port's counterpart of
    the reference's donated-buffer check). Built before a dispatch over
    the state tensors the run may update in place: a tensor's version
    counter moves with every in-place write PyTorch records."""

    __slots__ = ('_tensors', '_versions')

    def __init__(self, tensors=()):
        self._tensors = [t for t in tensors if isinstance(t, torch.Tensor)]
        self._versions = [t._version for t in self._tensors]

    def written(self):
        return any(t._version != v
                   for t, v in zip(self._tensors, self._versions))


class RetryPolicy(object):
    """Exponential backoff with full jitter and a wall-clock deadline.

    max_attempts counts TOTAL tries (first + retries). Delay before retry
    k (1-based) is ``min(max_delay, base * multiplier**(k-1))`` scaled by
    a uniform jitter in [1-jitter, 1+jitter]; the deadline bounds the sum
    of sleeps so a retry loop can never outlive its caller's patience.
    Defaults come from PADDLE_RETRY_* env vars at construction time."""

    def __init__(self, max_attempts=None, base_delay_s=None, max_delay_s=None,
                 multiplier=2.0, jitter=0.25, deadline_s=None):
        self.max_attempts = int(max_attempts if max_attempts is not None
                                else _env_float('PADDLE_RETRY_MAX_ATTEMPTS', 4))
        self.base_delay_s = (base_delay_s if base_delay_s is not None
                             else _env_float('PADDLE_RETRY_BASE_S', 0.05))
        self.max_delay_s = (max_delay_s if max_delay_s is not None
                            else _env_float('PADDLE_RETRY_MAX_S', 2.0))
        self.multiplier = float(multiplier)
        self.jitter = float(jitter)
        self.deadline_s = (deadline_s if deadline_s is not None
                           else _env_float('PADDLE_RETRY_DEADLINE_S', 30.0))
        seed = os.environ.get('PADDLE_FAULT_SEED')
        self._rng = random.Random(int(seed)) if seed else random.Random()

    def delay(self, attempt):
        """Backoff before retry `attempt` (1-based), jittered."""
        d = min(self.max_delay_s,
                self.base_delay_s * (self.multiplier ** (attempt - 1)))
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return max(0.0, d)

    def call(self, fn, site='generic', retryable=None, state=None):
        """Run fn(); on a transient error, back off and re-invoke until
        success, a permanent error, attempt exhaustion, or the deadline.
        See :meth:`resume` for `state`."""
        try:
            return fn()
        except Exception as e:          # noqa: BLE001 — classified below
            return self.resume(e, fn, site=site, retryable=retryable,
                               state=state)

    def resume(self, exc, fn, site='generic', retryable=None, state=None):
        """The except-block half of call(): given an already-raised `exc`,
        retry fn() under this policy. Re-raises `exc` unchanged when it is
        not retryable. ``state`` (a `StateWrites`) refuses a retry once the
        failed attempt wrote state in place."""
        check = retryable if retryable is not None else is_transient
        if not check(exc):
            raise exc

        def _written_giveup(cause):
            monitor.inc('retry_giveup_total', labels={'site': site})
            trace_mod.note('retry_giveup', site=site, reason='written',
                           error=type(cause).__name__)
            blackbox.record('retry_giveup', error=cause, site=site,
                            reason='written')
            return RuntimeError(
                "cannot retry %r after %s: the failed attempt had already "
                "written state in place (an optimizer update), so the "
                "state is half-updated; restore it (TrainingGuard, a "
                "checkpoint) before running again"
                % (site, type(cause).__name__))

        if state is not None and state.written():
            raise _written_giveup(exc) from exc
        t0 = time.monotonic()
        last = exc
        for attempt in range(1, self.max_attempts):
            d = self.delay(attempt)
            if time.monotonic() + d - t0 > self.deadline_s:
                break
            monitor.inc('retry_attempt_total', labels={'site': site})
            # the backoff sleep is dead wall the device sits idle for (the
            # goodput layer's 'retry_backoff' loss bucket)
            monitor.observe('retry_backoff_seconds', d,
                            labels={'site': site})
            with monitor.span('retry_backoff:%s' % site):
                time.sleep(d)
            try:
                return fn()
            except Exception as e:      # noqa: BLE001 — classified below
                last = e
                if not check(e):
                    raise
                if state is not None and state.written():
                    raise _written_giveup(e) from e
        monitor.inc('retry_giveup_total', labels={'site': site})
        trace_mod.note('retry_giveup', site=site, reason='exhausted',
                       error=type(last).__name__)
        blackbox.record('retry_giveup', error=last, site=site,
                        reason='exhausted', attempts=self.max_attempts)
        raise last


def retry_call(fn, site='generic', policy=None, retryable=None, state=None):
    """Run fn() under `policy` (default: env-configured RetryPolicy)."""
    return (policy or RetryPolicy()).call(fn, site=site, retryable=retryable,
                                          state=state)


def retry_after(exc, fn, site='generic', policy=None, retryable=None,
                state=None):
    """Except-block entry point: re-raise `exc` if permanent, else retry
    fn() with backoff. Keeps the success path of hot callers free of
    retry machinery."""
    return (policy or RetryPolicy()).resume(exc, fn, site=site,
                                            retryable=retryable, state=state)


# ---------------------------------------------------------------------------
# checkpoint hardening primitives (used by checkpoint.py / io.py)


MANIFEST_NAME = 'paddle_manifest.json'


def array_crc32(arr):
    """Stable content digest of one tensor: crc32 over dtype/shape header +
    raw bytes (C order). Cheap enough to run at every checkpoint write."""
    arr = np.ascontiguousarray(arr)
    head = ('%s|%s|' % (arr.dtype.str, arr.shape)).encode()
    return zlib.crc32(arr.tobytes(), zlib.crc32(head)) & 0xFFFFFFFF


def build_manifest(state, step=None, extra=None):
    """Manifest dict for a state dict ({name: numpy array or tensor}):
    per-tensor shape/dtype/crc32 (a tensor read as the executor hands it
    out: a host copy, bf16 as float32). A value that cannot be read
    records crc32=None — present-and-well-formed is still checked.

    Cost note: the crc reads every tensor to the host and crc32s all its
    bytes (~1 GB/s). For multi-GB state ``PADDLE_CKPT_CRC=0`` keeps the
    structural manifest (names/shapes/dtypes verified at restore)
    without crcs."""
    want_crc = os.environ.get('PADDLE_CKPT_CRC', '1') != '0'
    tensors = {}
    for name, v in state.items():
        ent = {'crc32': None, 'shape': None, 'dtype': None}
        try:
            if want_crc or not hasattr(v, 'dtype'):
                arr = _host(v)
                ent = {'crc32': array_crc32(arr) if want_crc else None,
                       'shape': list(arr.shape), 'dtype': str(arr.dtype)}
            else:
                # metadata without the copy to the host
                ent = {'crc32': None, 'shape': list(v.shape),
                       'dtype': _dtype_name(v)}
        except Exception:
            pass                        # unreadable value: structural only
        tensors[name] = ent
    out = {'format': 'paddle_tpu_ckpt', 'version': 1, 'step': step,
           'tensors': tensors}
    if extra:
        out.update(extra)
    return out


def verify_manifest(manifest, restored):
    """Names whose restored bytes do not match the manifest (missing,
    shape/dtype drift, or crc mismatch). Empty list == valid."""
    bad = []
    for name, ent in manifest.get('tensors', {}).items():
        if name not in restored:
            bad.append(name)
            continue
        if ent.get('shape') is None:
            continue                    # recorded as unverifiable at save
        arr = _host(restored[name])
        if (list(arr.shape) != ent.get('shape')
                or str(arr.dtype) != ent.get('dtype')):
            bad.append(name)
        elif ent.get('crc32') is not None and \
                array_crc32(arr) != ent['crc32']:
            bad.append(name)
    return bad


def fsync_dir(path):
    """fsync a DIRECTORY so a rename into it survives power loss; no-op on
    filesystems/platforms without directory fds."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_bytes(path, data):
    """tmp + fsync + rename publication of one file: readers observe the
    old content or the new content, never a torn write. The ckpt_write
    fault site fires BETWEEN write and publish — the worst crash point —
    and the tmp file is always cleaned up."""
    tmp = path + '.tmp.%d' % os.getpid()
    try:
        with open(tmp, 'wb') as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        maybe_fault('ckpt_write')
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    fsync_dir(os.path.dirname(os.path.abspath(path)))


def pid_alive(pid):
    """Best-effort liveness probe shared by the tmp-sweep paths (here and
    checkpoint._clean_stale_tmp): EPERM counts as alive."""
    if pid is None:
        return False
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except OSError:
        return True


def sweep_stale_tmp_files(dirname):
    """Remove '*.tmp.<pid>[.npy|.npz]' leftovers from crashed
    atomic_file/atomic_write_bytes writers — without a sweep they
    accumulate full-size partial files across every crash of a
    long-lived job until the save directory hits ENOSPC. A file is
    swept only when its writer pid is gone AND it is older than
    PADDLE_CKPT_TMP_TTL_S (default 1 h): pid liveness is host-local, so
    on shared storage another HOST's in-flight write looks pid-dead —
    the age guard is what actually protects it (an atomic publish window
    is seconds; leftovers age indefinitely)."""
    try:
        names = os.listdir(dirname)
    except OSError:
        return
    ttl = _env_float('PADDLE_CKPT_TMP_TTL_S', 3600.0)
    for n in names:
        if '.tmp.' not in n:
            continue
        pid_part = n.split('.tmp.', 1)[1].split('.', 1)[0]
        if not pid_part.isdigit() or pid_alive(int(pid_part)):
            continue
        path = os.path.join(dirname, n)
        try:
            if not os.path.isfile(path) or \
                    time.time() - os.path.getmtime(path) < ttl:
                continue
            os.unlink(path)
        except OSError:
            pass


class atomic_file(object):
    """Context manager for tmp+fsync+rename file publication::

        with resilience.atomic_file(path) as tmp:
            np.savez(tmp, **arrays)

    The body writes to `tmp`; on success the file is fsynced, the
    ``ckpt_write`` fault site is checked, and the tmp is renamed over
    `path` (readers never observe a torn file). On failure the tmp is
    removed and nothing is published."""

    def __init__(self, path):
        self._path = path
        self._tmp = path + '.tmp.%d' % os.getpid()

    def __enter__(self):
        return self._tmp

    def _resolve_tmp(self):
        # np.save/np.savez append .npy/.npz when missing — accept either
        # the exact tmp name or the extended one
        if not os.path.exists(self._tmp):
            for ext in ('.npy', '.npz'):
                if os.path.exists(self._tmp + ext):
                    return self._tmp + ext
        return self._tmp

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            # the body may have written the EXTENDED name before failing
            # (np.savez mid-write ENOSPC) — remove whichever exists
            try:
                os.unlink(self._resolve_tmp())
            except OSError:
                pass
            return False
        tmp = self._resolve_tmp()
        try:
            with open(tmp, 'rb') as f:
                os.fsync(f.fileno())
            maybe_fault('ckpt_write')
            os.replace(tmp, self._path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        fsync_dir(os.path.dirname(os.path.abspath(self._path)))
        return False


def write_manifest(dirname, manifest):
    import json
    atomic_write_bytes(os.path.join(dirname, MANIFEST_NAME),
                       json.dumps(manifest, sort_keys=True).encode())


def read_manifest(dirname):
    """Manifest dict, or None when absent/unreadable (pre-hardening
    checkpoints stay loadable; they just can't be crc-verified)."""
    import json
    path = os.path.join(dirname, MANIFEST_NAME)
    try:
        with open(path, 'rb') as f:
            return json.loads(f.read().decode())
    except (OSError, ValueError):
        return None


def _host(v):
    """A host numpy view of a scope value (a tensor as the executor hands
    it out: a copy on the host, bf16 as float32)."""
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.detach().to('cpu').numpy()
    return np.asarray(v)


def _dtype_name(v):
    if isinstance(v, torch.Tensor):
        return 'float32' if v.dtype == torch.bfloat16 else \
            str(v.dtype).replace('torch.', '')
    return str(v.dtype)


# ---------------------------------------------------------------------------
# non-finite-step recovery


def foreach_copy(dsts, srcs):
    """``dst.copy_(src)`` for each pair, as one multi-tensor copy a dtype:
    ``torch._foreach_copy_`` takes its one-launch route only over tensors
    of one dtype and device."""
    groups = {}
    for d, s in zip(dsts, srcs):
        g = groups.setdefault((s.dtype, s.device), ([], []))
        g[0].append(d)
        g[1].append(s)
    for ds, ss in groups.values():
        torch._foreach_copy_(ds, ss)


def _finite(value):
    if isinstance(value, torch.Tensor):
        return not value.is_floating_point() or \
            bool(torch.isfinite(value).all())
    arr = np.asarray(value)
    return arr.dtype.kind != 'f' or bool(np.isfinite(arr).all())


def _copy(v):
    if isinstance(v, torch.Tensor):
        return v.detach().clone()
    return np.array(v, copy=True)


class TrainingGuard(object):
    """Step wrapper that survives non-finite losses.

    ::

        guard = resilience.TrainingGuard(exe, main_prog, loss_name=loss.name,
                                         scope=scope, max_bad_steps=3)
        for batch in data:
            fetches = guard.step(feed=batch, fetch_list=[loss])
            if guard.last_step_skipped:
                continue            # optimizer update was rolled back

    Before each step the guard copies every persistable the program writes
    (:meth:`_snapshot`: a multi-tensor copy into buffers it keeps, the
    bytes of the written state; ``snapshot_bytes`` holds their sum), the
    LoD table and the
    program's RNG run counter. If the fetched loss — or any float fetch,
    or, with ``check_state=True``, any written state entry — comes back
    non-finite, the copies go back into the same tensors (``copy_``, and
    the scope bound to them again, so a bound graph that holds their
    addresses reads the restored values), the state the bad step created
    is dropped, the RNG run counter is rewound (the next step draws what
    the rolled-back one drew), ``nonfinite_skip_total`` is incremented,
    and an optional loss-scale scalar (``loss_scale_name``) is multiplied
    by ``backoff_factor``. After ``max_bad_steps`` CONSECUTIVE bad steps it
    raises NonFiniteError (with a ``nonfinite_escalate`` flight-recorder
    bundle when ``PADDLE_BLACKBOX=1``). A finite step resets the streak
    and, when ``growth_interval`` > 0, multiplies the loss scale by
    ``growth_factor`` every that many good steps (up to
    ``max_loss_scale``). The guard composes with FLAGS_check_nan_inf: the
    executor's NaN raise is caught and treated as a bad step, and its
    localization reused. ``health``: None follows ``PADDLE_HEALTH``;
    True or 'watch' instruments the program (health.py) and observes each
    step's stats; 'preempt' also rolls back a confirmed grad_explosion or
    loss_spike before anything is non-finite.
    """

    def __init__(self, executor, program, loss_name=None, scope=None,
                 max_bad_steps=3, loss_scale_name=None, backoff_factor=0.5,
                 growth_interval=0, growth_factor=2.0,
                 max_loss_scale=2.0 ** 15, check_state=False, health=None):
        if max_bad_steps < 1:
            raise ValueError("max_bad_steps must be >= 1")
        self._exe = executor
        self._program = program
        self._loss_name = loss_name
        self._scope = scope
        from . import health as _health_mod
        mode = health
        if mode is None:
            mode = 'watch' if _health_mod.enabled() else False
        elif mode is True:
            mode = 'watch'
        if mode not in (False, 'watch', 'preempt'):
            raise ValueError("health must be one of None/True/False/"
                             "'watch'/'preempt', got %r" % (health,))
        self.health_mode = mode or None
        if self.health_mode:
            _health_mod.instrument(program, loss_name)
        self.max_bad_steps = int(max_bad_steps)
        self.loss_scale_name = loss_scale_name
        self.backoff_factor = float(backoff_factor)
        self.growth_interval = int(growth_interval)
        self.growth_factor = float(growth_factor)
        self.max_loss_scale = float(max_loss_scale)
        self.check_state = bool(check_state)
        self.bad_steps = 0              # consecutive
        self.total_skipped = 0
        self.last_step_skipped = False
        # PADDLE_NAN_LOCALIZE=1: info dict of the op the last bad step's
        # non-finite value was localized to (analysis.localize_nonfinite),
        # None when localization is off / found nothing / step was good
        self.last_localization = None
        self.snapshot_bytes = 0
        self._buffers = {}              # name -> the snapshot's tensor
        self._good_streak = 0
        self._written_cache = None      # (program version, names)

    def _written_names(self):
        cached = self._written_cache
        if cached is not None and cached[0] == self._program._version:
            return cached[1]
        from .core import lowering
        _, written = lowering.analyze_state(self._program, [])
        names = sorted(written)
        self._written_cache = (self._program._version, names)
        return names

    def _scale_adjust(self, scope, factor):
        if not self.loss_scale_name or not scope.has(self.loss_scale_name):
            return
        cur = scope.get(self.loss_scale_name)
        if isinstance(cur, torch.Tensor):
            cur.copy_(torch.clamp(cur * factor, max=self.max_loss_scale))
            return
        cur = np.asarray(cur)
        new = np.minimum(cur * factor, self.max_loss_scale).astype(cur.dtype)
        scope.set(self.loss_scale_name, new)

    # -- shared snapshot/restore (NaN path AND preemptive health path) ----
    def _snapshot(self, scope):
        """A copy of every written persistable (with the object the scope
        held, which the rollback writes back into), the LoD table and the
        program's RNG run counter. The tensors' copies go into buffers the
        guard keeps from step to step, in one multi-tensor copy."""
        state = {}
        srcs, dsts = [], []
        for n in self._written_names():
            if not scope.has(n):
                continue
            v = scope.get(n)
            if not isinstance(v, torch.Tensor):
                state[n] = (v, _copy(v))
                continue
            buf = self._buffers.get(n)
            if buf is None or buf.shape != v.shape or \
                    buf.dtype != v.dtype or buf.device != v.device:
                buf = self._buffers[n] = torch.empty_like(v)
            srcs.append(v.detach())
            dsts.append(buf)
            state[n] = (v, buf)
        foreach_copy(dsts, srcs)
        self.snapshot_bytes = sum(int(c.nbytes) for _, c in state.values())
        return {'state': state,
                'lods': dict(getattr(scope, '_lods', {})),
                'rng': int(getattr(self._program, '_rng_run_counter', 0)
                           or 0)}

    def _restore(self, scope, snap):
        """Roll the scope back to a _snapshot and REWIND the RNG run counter
        (the checkpoint-restore rewind rule): the retried step replays the
        same dropout stream the rolled-back step consumed, so a guarded
        trajectory with a skipped step is bit-identical to an unguarded
        one over the same good batches. The failed step's own seed stays
        on program._last_run_seed for NaN localization."""
        back = [(orig, c) for orig, c in snap['state'].values()
                if isinstance(orig, torch.Tensor)]
        foreach_copy([o.detach() for o, _ in back], [c for _, c in back])
        for n, (orig, c) in snap['state'].items():
            scope.set(n, orig if isinstance(orig, torch.Tensor) else c)
        scope._lods = snap['lods']
        # drop state the bad step CREATED (not present pre-step): a
        # half-written first step must not survive the rollback
        for n in self._written_names():
            if n not in snap['state'] and scope.has(n):
                scope.drop(n)
        self._program._rng_run_counter = snap['rng']

    def stats(self):
        """Loop-surface stats block; ['health'] carries the observatory
        view when health mode is on (None otherwise)."""
        out = {'bad_steps': self.bad_steps,
               'total_skipped': self.total_skipped,
               'last_step_skipped': self.last_step_skipped,
               'health_mode': self.health_mode,
               'health': None}
        if self.health_mode:
            from . import health as _health_mod
            out['health'] = _health_mod.stats(self._program)
        return out

    def step(self, feed=None, fetch_list=None, **run_kw):
        """One guarded executor run; returns the fetches of the requested
        fetch_list (loss is fetched internally when not already listed).
        On a skipped step the returned fetches are the BAD values (for
        logging) and the scope holds the rolled-back state."""
        from .executor import global_scope
        scope = self._scope if self._scope is not None else global_scope()
        fetch_list = list(fetch_list or [])
        names = [v if isinstance(v, str) else v.name for v in fetch_list]
        extra_loss = (self._loss_name is not None
                      and self._loss_name not in names)
        run_fetch = fetch_list + ([self._loss_name] if extra_loss else [])
        health_fetch = None
        if self.health_mode:
            from . import health as _health_mod
            hf = _health_mod.fetch_name(self._program)
            if hf and hf not in names:
                health_fetch = hf
                run_fetch = run_fetch + [hf]

        snap = self._snapshot(scope)

        bad = False
        raised = False
        run_localization = None     # executor-side provenance, if it ran
        fetches = []
        try:
            fetches = self._exe.run(self._program, feed=feed,
                                    fetch_list=run_fetch, scope=scope,
                                    **run_kw)
        except (RuntimeError, FloatingPointError) as e:
            # FLAGS_check_nan_inf / FLAGS_debug_nans surface the bad step
            # as a raise; anything else propagates untouched
            if not isinstance(e, FloatingPointError) and \
                    'NaN/Inf' not in str(e) and \
                    'returned nan values' not in str(e):
                raise
            bad = True
            raised = True
            run_localization = getattr(e, 'nonfinite_localization', None)
            # the raise swallowed the fetch values: NaN stand-ins, shaped
            # [1] as scalar fetches are on the normal path
            fetches = [np.full((1,), np.nan, np.float32)
                       for _ in run_fetch]

        if not bad:
            bad = not all(_finite(v) for v in fetches)
            if not bad and self.check_state:
                bad = not all(
                    _finite(scope.get(n)) for n in self._written_names()
                    if scope.has(n))

        # health observatory: decode the stat vector the step already
        # fetched (not on the raise path: its fetches are stand-ins)
        detected = ()
        preempt = False
        if health_fetch and not raised and fetches:
            from . import health as _health_mod
            detected = _health_mod.observe(self._program, fetches[-1])
            if not bad and self.health_mode == 'preempt' and \
                    any(k in _health_mod.PREEMPT_KINDS for k in detected):
                # confirmed divergence while everything is still finite:
                # roll back NOW, before a NaN destroys the evidence
                preempt = True
                monitor.inc('health_preempt_rollback_total')

        if bad or preempt:
            self._restore(scope, snap)
            if preempt:
                self.last_localization = None
            elif run_localization is not None:
                self.last_localization = run_localization
            else:
                from . import analysis
                self.last_localization = analysis.localize_from_scope(
                    self._exe, self._program, feed, scope,
                    getattr(self._program, '_last_run_seed', None))
            self._scale_adjust(scope, self.backoff_factor)
            self.bad_steps += 1
            self.total_skipped += 1
            self._good_streak = 0
            self.last_step_skipped = True
            if not preempt:
                monitor.inc('nonfinite_skip_total')
            if self.bad_steps >= self.max_bad_steps:
                monitor.inc('nonfinite_escalate_total')
                from . import analysis
                where = ''
                if self.last_localization:
                    where = '; ' + analysis.format_localization(
                        self.last_localization)
                if blackbox.enabled():
                    # the replayable incident: the rolled-back pre-step
                    # state (copies: training may go on and update the
                    # scope's tensors before the writer thread reads
                    # them) and the failed step's run seed
                    prog = self._program
                    extra = {}
                    if self.health_mode:
                        from . import health as _health_mod
                        extra['health'] = _health_mod.stats(prog)
                    blackbox.record(
                        'nonfinite_escalate', program=prog, feed=feed,
                        state={n: _copy(scope.get(n))
                               for n in scope.names()
                               if hasattr(scope.get(n), 'shape')},
                        lods=dict(getattr(scope, '_lods', {})),
                        key_arr=getattr(prog, '_last_run_seed', None),
                        localization=self.last_localization,
                        bad_steps=self.bad_steps,
                        loss=self._loss_name, **extra)
                raise NonFiniteError(
                    "TrainingGuard: %d consecutive %s steps "
                    "(loss %r) — the optimizer update was skipped each "
                    "time; inspect the data pipeline / lower the learning "
                    "rate / check loss scaling%s"
                    % (self.bad_steps,
                       'non-finite' if not preempt
                       else 'diverging (health-preempted)',
                       self._loss_name or '<unnamed>', where))
        else:
            self.bad_steps = 0
            self.last_step_skipped = False
            self.last_localization = None
            self._good_streak += 1
            if self.growth_interval and \
                    self._good_streak % self.growth_interval == 0:
                self._scale_adjust(scope, self.growth_factor)

        if extra_loss or health_fetch:
            return fetches[:len(fetch_list)]
        return fetches
