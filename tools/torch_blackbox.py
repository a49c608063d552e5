"""Inspect and replay the flight-recorder bundles of paddle_tpu_torch.

A bundle is the directory ``paddle_tpu_torch.blackbox`` publishes when a
detector fires (a TrainingGuard escalation, a retry give-up, a training
anomaly, a goodput sentinel, ...). Subcommands:

- ``list <dir>``: one line per bundle under a bundle root (wall time,
  kind, step, error);
- ``show <bundle>``: the manifest, the NaN localization, the failure
  counters of the captured monitor snapshot and the goodput regression
  log;
- ``diff <a> <b>``: counter and goodput-regression deltas between two
  bundles' snapshots;
- ``replay <bundle>``: rebuild the captured program, the pre-step state,
  the feed and the run's seed from ``replay/``, re-execute the failed step
  through ``analysis.localize_from_scope`` and print which op went
  non-finite first, then REPRODUCED or DIFFERS against the localization
  the bundle recorded. A bundle the JAX package wrote replays too: its
  program and arrays load the same way; its ``run_key.npy`` is a JAX
  PRNG key, which the port cannot draw from, so such a replay is exact
  for a program that draws no random numbers (the key is reported as
  foreign).

Usage:
    python tools/torch_blackbox.py list blackbox/
    python tools/torch_blackbox.py show blackbox/bundle_nonfinite_escalate_...
    python tools/torch_blackbox.py diff <bundle_a> <bundle_b>
    python tools/torch_blackbox.py replay <bundle> [--device cpu]

``replay`` runs on ``cuda:0`` unless ``--device cpu`` is given.
"""
import argparse
import json
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)


def _manifest(bundle):
    path = os.path.join(bundle, 'manifest.json')
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError) as e:
        raise SystemExit('%s: not a readable bundle (%s)' % (bundle, e))


def _read_json(bundle, name):
    try:
        with open(os.path.join(bundle, name)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def cmd_list(args):
    from paddle_tpu_torch import blackbox
    found = blackbox.bundles(args.dir)
    if not found:
        print('no bundles under %s' % args.dir)
        return
    w = sys.stdout.write
    w('%-24s %-20s %6s  %s\n' % ('wall', 'kind', 'step', 'bundle'))
    for b in found:
        m = _manifest(b)
        step = m.get('step')
        w('%-24s %-20s %6s  %s\n'
          % (m.get('wall', '?'), m.get('kind', '?'),
             step if step is not None else '-', os.path.basename(b)))
        if m.get('error'):
            w('%-24s   error: %s\n' % ('', m['error'][:120]))
    w('%d bundle(s)\n' % len(found))


def cmd_show(args):
    from paddle_tpu_torch import analysis
    m = _manifest(args.bundle)
    w = sys.stdout.write
    for key in ('kind', 'wall', 'step', 'rank', 'pid', 'trace_id',
                'error', 'fingerprint', 'replayable'):
        if m.get(key) is not None:
            w('%-12s %s\n' % (key + ':', m[key]))
    if m.get('trigger'):
        w('trigger:\n')
        for k, v in sorted(m['trigger'].items()):
            w('  %-20s %s\n' % (k, v))
    if m.get('rng'):
        w('rng:         seed=%s run_counter=%s\n'
          % (m['rng'].get('random_seed'), m['rng'].get('run_counter')))
    if m.get('localization'):
        w('localization: %s\n'
          % analysis.format_localization(m['localization']))
    if m.get('capture_errors'):
        w('capture errors (bundle is partial):\n')
        for e in m['capture_errors']:
            w('  %s\n' % e)
    snap = _read_json(args.bundle, 'monitor.json')
    if snap:
        counters = snap.get('counters') or {}
        interesting = sorted(
            k for k in counters
            if any(t in k for t in ('error', 'giveup', 'regression',
                                    'nonfinite', 'failure', 'fault')))
        if interesting:
            w('failure counters at capture:\n')
            for k in interesting:
                w('  %-44s %g\n' % (k, counters[k]))
    gp = _read_json(args.bundle, 'goodput.json')
    if gp and gp.get('regressions'):
        w('goodput regression log (newest last):\n')
        for r in gp['regressions'][-5:]:
            w('  %s\n' % json.dumps(r, sort_keys=True))
    w('files: %s\n' % ' '.join(m.get('files', [])))


def cmd_diff(args):
    ma, mb = _manifest(args.a), _manifest(args.b)
    w = sys.stdout.write
    w('a: %s (%s @ %s)\n' % (args.a, ma.get('kind'), ma.get('wall')))
    w('b: %s (%s @ %s)\n' % (args.b, mb.get('kind'), mb.get('wall')))
    ca = (_read_json(args.a, 'monitor.json') or {}).get('counters') or {}
    cb = (_read_json(args.b, 'monitor.json') or {}).get('counters') or {}
    deltas = [(k, cb.get(k, 0) - ca.get(k, 0))
              for k in sorted(set(ca) | set(cb))
              if cb.get(k, 0) - ca.get(k, 0)]
    if deltas:
        w('\ncounter deltas (b - a):\n')
        for k, d in deltas:
            w('  %-44s %+g\n' % (k, d))
    else:
        w('\nno counter deltas\n')
    ra = (_read_json(args.a, 'goodput.json') or {}).get('regressions') or []
    rb = (_read_json(args.b, 'goodput.json') or {}).get('regressions') or []
    if len(ra) != len(rb):
        w('\ngoodput regressions: %d -> %d; newest in b:\n'
          % (len(ra), len(rb)))
        for r in rb[len(ra):][-5:]:
            w('  %s\n' % json.dumps(r, sort_keys=True))


def _load_arrays(rdir, meta, stem):
    import numpy as np
    names = meta.get('%s_names' % stem) or []
    if not names:
        return {}
    with np.load(os.path.join(rdir, stem + '.npz')) as z:
        return {n: z['arr_%d' % i] for i, n in enumerate(names)}


def cmd_replay(args):
    m = _manifest(args.bundle)
    if 'program.json' not in (m.get('files') or []):
        raise SystemExit('%s: no captured program — this bundle kind (%s) '
                         'is not replayable' % (args.bundle, m.get('kind')))
    rdir = os.path.join(args.bundle, 'replay')
    meta = _read_json(args.bundle, 'replay/replay.json')
    if meta is None:
        raise SystemExit('%s: no replay/ capture — the trigger did not '
                         'carry step state' % args.bundle)
    # localization on: the replay exists to reproduce the provenance
    os.environ.setdefault('PADDLE_NAN_LOCALIZE', '1')
    import numpy as np
    from paddle_tpu_torch import analysis
    from paddle_tpu_torch.core import serialization
    from paddle_tpu_torch.core.lod import normalize_lod
    from paddle_tpu_torch.executor import Executor, Scope
    from paddle_tpu_torch.framework import CPUPlace
    prog = serialization.program_from_dict(
        _read_json(args.bundle, 'program.json'))
    feed = _load_arrays(rdir, meta, 'feed')
    state = _load_arrays(rdir, meta, 'state')
    key_path = os.path.join(rdir, 'run_key.npy')
    key = np.load(key_path) if os.path.exists(key_path) else None
    # the port records its run's seed (a 0-d integer); a JAX bundle its
    # PRNG key (a vector), whose bits the port's generators cannot draw
    seed = int(key) if key is not None and key.ndim == 0 else None
    what = ('seed %d' % seed if seed is not None else
            'ABSENT' if key is None else 'a JAX key (foreign: draws differ)')
    scope = Scope()
    scope.update(state)
    scope._lods = {k: normalize_lod(v)
                   for k, v in (meta.get('lods') or {}).items() if v}
    print('replaying %s: program %s..., %d feed vars, %d state vars, run %s'
          % (m.get('kind'), (m.get('fingerprint') or '?')[:16], len(feed),
             len(state), what))
    exe = Executor(CPUPlace() if args.device == 'cpu' else None)
    info = analysis.localize_from_scope(exe, prog, feed or None, scope, seed)
    if info is None:
        print('replay completed FINITE — the captured step did not '
              'reproduce the non-finite value (compare env.json against '
              'this host)')
        raise SystemExit(2)
    print(analysis.format_localization(info))
    recorded = m.get('localization')
    if recorded:
        match = recorded.get('op_index') == info.get('op_index')
        print('recorded localization: op_index=%s op_type=%s -> %s'
              % (recorded.get('op_index'), recorded.get('op_type'),
                 'REPRODUCED' if match else 'DIFFERS'))


def main(argv=None):
    p = argparse.ArgumentParser(
        description='List, inspect, diff, and replay the flight-recorder '
                    'bundles of paddle_tpu_torch')
    sub = p.add_subparsers(dest='cmd', required=True)
    sp = sub.add_parser('list', help='one line per bundle under a root')
    sp.add_argument('dir')
    sp.set_defaults(fn=cmd_list)
    sp = sub.add_parser('show', help='manifest + headline numbers')
    sp.add_argument('bundle')
    sp.set_defaults(fn=cmd_show)
    sp = sub.add_parser('diff', help='counter/goodput deltas a -> b')
    sp.add_argument('a')
    sp.add_argument('b')
    sp.set_defaults(fn=cmd_diff)
    sp = sub.add_parser('replay', help='re-execute the captured step '
                                       'through the NaN localizer')
    sp.add_argument('bundle')
    sp.add_argument('--device', choices=('cuda', 'cpu'), default='cuda',
                    help='where the replay runs (default: the card)')
    sp.set_defaults(fn=cmd_replay)
    args = p.parse_args(argv)
    args.fn(args)


if __name__ == '__main__':
    main()
