#!/usr/bin/env python3
"""Build variants of the embedding gather source and time them on one GPU,
in turns, at every shape the port's paths give the gather.

    python3 tools/gather_variants.py DIR '{"name": "file.cu [nvcc flags]"}'
        [--reps N] [--shapes NAME,...] [--sass]

A variant is a copy of ``paddle_tpu_torch/csrc/embedding_gather.cu`` under
DIR (an earlier commit's copy, or this one's changed by hand): a comparison
or an ablation lives in such a copy, never as a switch in csrc/. Every
variant exports the same C entry point, ``ptt_embedding_gather``. nvcc
builds them all at once with the port's own flags (``native.NVCC_FLAGS``:
sm_90a, -O3, -Xptxas -v), one shared library each in DIR.

At each shape (`SHAPES`: the decode rows of the LM's [32000, 512] table,
the LM and BERT training rows, the stacked LSTM's buckets, the two CTR
rows, and one CTR batch 16 times the bench's) each variant is first held
bitwise to the plain version (``embedding_ops._gather_ref``) on one id set
with ids that clamp (below 0, at V, past V), without and with a bias. Then each variant's call, the
plain version and ``F.embedding`` are timed as chip_smoke.py's
`gather_times` times them: CUDA-graph replays over rotating id sets whose
working set is three L2 caches. The variants run in the order given and
back again, ``--reps`` times (a, b, b, a).

Prints one JSON line per build (the registers and spills of each kernel
instantiation; with ``--sass`` also, from ``cuobjdump -sass``, each
kernel's count of instructions before its first global load, the chain a
launch at decode's few rows waits on, and in all) and one per shape: each variant's least time, every time,
its share of the bound (bytes: each id, table row and output row once, the
rows read counted as at most the table's), the plain version's and
``F.embedding``'s times, with the card's name and power limit. Exits 1 if a
variant disagrees and 2 if one does not build or there is no card.
"""
import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (name, table rows, width, ids)
SHAPES = (
    ('decode_n8', 32000, 512, 8), ('decode_n16', 32000, 512, 16),
    ('decode_n64', 32000, 512, 64), ('decode_n80', 32000, 512, 80),
    ('decode_n128', 32000, 512, 128), ('decode_n256', 32000, 512, 256),
    ('lm_train', 32000, 512, 8192), ('bert_word', 30522, 768, 4096),
    ('bert_type', 2, 768, 4096),
    ('lstm_l64', 5000, 128, 2048), ('lstm_l96', 5000, 128, 3072),
    ('lstm_l128', 5000, 128, 4096),
    ('ctr_sparse', 100000, 16, 13312), ('ctr_sharded_v1m', 1 << 20, 32, 13312),
)


def sass_report(lib):
    """{kernel: [instructions before its first global load, instructions
    in all]} of the built library ``lib``, NOPs left out."""
    from paddle_tpu_torch import native
    tool = os.path.join(os.path.dirname(native.nvcc_path()), 'cuobjdump')
    text = subprocess.run([tool, '-sass', lib], capture_output=True,
                          text=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r'\s*Function : (\S+)', line)
        if m:
            name = m.group(1)
            out[name] = [None, 0]
            continue
        m = re.match(r'\s*/\*[0-9a-f]{4,}\*/\s+([^;]*);', line)
        if name is None or m is None or m.group(1).startswith('NOP'):
            continue
        if out[name][0] is None and 'LDG' in m.group(1):
            out[name][0] = out[name][1]
        out[name][1] += 1
    return out


def build(directory, variants, sass=False):
    """{name: loaded library} of ``variants`` ({name: 'file.cu [flags]'},
    files under ``directory``), all compiled at once."""
    import chip_smoke
    from paddle_tpu_torch import native
    procs = {}
    for name, spec in variants.items():
        src, *flags = spec.split()
        lib = os.path.join(directory, 'lib_%s.so' % name)
        procs[name] = lib, subprocess.Popen(
            [native.nvcc_path(), *native.NVCC_FLAGS, '-o', lib,
             os.path.join(directory, src), *flags],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0].decode(errors='replace')
        rep = dict(variant=name, rc=proc.returncode,
                   ptxas=chip_smoke.ptxas_report({name: log})[name])
        if sass and not proc.returncode:
            rep['sass'] = sass_report(lib)
        print(json.dumps(rep), flush=True)
        if proc.returncode:
            print(log[-4000:], file=sys.stderr)
            raise SystemExit(2)
        fn = ctypes.CDLL(lib).ptt_embedding_gather
        P, I = ctypes.c_void_p, ctypes.c_int64
        fn.argtypes = [P, P, P, P, I, I, I, P]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def caller(torch, fn, name, w, bias=None):
    """``ids -> out``: the variant's launch on the current stream."""
    def call(ids):
        out = torch.empty((ids.numel(), w.shape[1]), dtype=w.dtype,
                          device=w.device)
        rc = fn(w.data_ptr(), ids.data_ptr(),
                0 if bias is None else bias.data_ptr(), out.data_ptr(),
                ids.numel(), w.shape[0], w.shape[1],
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError('%s: CUDA error %d' % (name, rc))
        return out
    return call


def measure(fns, shapes, reps, card):
    """One JSON line per shape; returns whether every variant was exact."""
    import torch
    import torch.nn.functional as F
    import chip_smoke
    from paddle_tpu_torch.ops import embedding_ops
    dev = torch.device('cuda', 0)
    order = list(fns) + list(reversed(list(fns)))
    ok = True
    for shape, V, D, n in shapes:
        g = torch.Generator(device=dev).manual_seed(2121)
        w = torch.randn((V, D), generator=g, device=dev) * 0.02
        bias = torch.randn((D,), generator=g, device=dev)
        probe = torch.randint(0, V, (n,), generator=g, device=dev)
        probe[:4] = torch.tensor([-3, V, V + 7, -(1 << 40)])[:n]
        res = dict(shape=shape, table_rows=V, D=D, n=n, card=card)
        for name, fn in fns.items():
            res[name] = dict(exact=all(
                torch.equal(caller(torch, fn, name, w, b)(probe),
                            embedding_ops._gather_ref(w, probe, b))
                for b in (None, bias)))
            ok = ok and res[name]['exact']
        nbytes = (n + min(n, V)) * D * 4 + n * 8
        sets = [(torch.randint(0, V, (n,), generator=g, device=dev),)
                for _ in range(chip_smoke.rotation(nbytes))]
        times = {name: [] for name in fns}
        for _ in range(reps):
            for name in order:
                times[name].append(chip_smoke.rotating_ms(
                    torch, caller(torch, fns[name], name, w), sets))
        res.update(chip_smoke.bound(nbytes, 0),
                   plain_ms=chip_smoke.rotating_ms(
                       torch, lambda ids: embedding_ops._gather_ref(w, ids),
                       sets),
                   library_ms=chip_smoke.rotating_ms(
                       torch, lambda ids: F.embedding(ids, w), sets),
                   rotating_sets=len(sets))
        for name, ts in times.items():
            res[name].update(ms=min(ts), all=ts,
                             share_of_bound=res['bound_ms'] / min(ts))
        print(json.dumps(res), flush=True)
        del w, bias, probe, sets
        torch.cuda.empty_cache()
    return ok


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Build and time variants of the embedding gather.')
    parser.add_argument('dir', help='directory of the variant sources')
    parser.add_argument('variants',
                        help='JSON {name: "file.cu [nvcc flags]"}')
    parser.add_argument('--reps', type=int, default=2)
    parser.add_argument('--shapes', default='',
                        help='comma-separated names from SHAPES (all)')
    parser.add_argument('--sass', action='store_true',
                        help="each kernel's instructions before its first "
                             'global load, and in all')
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print('gather_variants: needs a CUDA card', file=sys.stderr)
        return 2
    want = [s for s in args.shapes.split(',') if s]
    shapes = [s for s in SHAPES if not want or s[0] in want]
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    fns = build(os.path.abspath(args.dir), json.loads(args.variants),
                args.sass)
    return 0 if measure(fns, shapes, args.reps, card) else 1


if __name__ == '__main__':
    sys.exit(main())
