#!/usr/bin/env python3
"""Build variants of the bf16 flash backward source and time them on one GPU,
in turns.

    python3 tools/flash_bf16_variants.py DIR '{"name": "file.cu [nvcc flags]"}'
        [--kernel dq|dkv|both] [--reps N] [--dh D,...] [--scale S,...]

A variant is a copy of ``paddle_tpu_torch/csrc/flash_attn_bf16_bwd.cu`` (the
headers it includes resolved from its own directory) under DIR, changed by
hand or by -D flags given after its file name: an ablation of a kernel lives
in such a copy, never as a switch in csrc/. nvcc builds every variant at
once with the port's own flags (``native.NVCC_FLAGS``: sm_90a, -O3,
-Xptxas -v), one shared library each in DIR. At chip_smoke.py's phase-13
shapes (the AMP LM step's, causal, and BERT's with its key-padding bias)
each variant's dQ (``--kernel dq``) or dK and dV (``dkv``) is held against
the plain PyTorch version: the largest error over the largest magnitude
within 1e-2, two calls bitwise equal, and the rows (for dK and dV the keys)
that keep nothing exactly 0; ``rms_err`` is the root mean square error over
the root mean square of the plain version. ``--dh`` and ``--scale`` (lists,
one run each) take other head widths and scales than the shapes' own (64,
dh^-0.5) at the same batch, heads and lengths; ``--kernel both`` runs dQ,
then dK/dV, from one build. Each variant's launch is then timed by
CUDA-graph replays (``chip_smoke.cuda_ms``) in the order given and back
again, ``--reps`` times, so that two variants alternate (a, b, b, a).

Prints one JSON line per build (the registers and spilled bytes of the
variant's dh-64 instantiations) and one per shape (each variant's checks,
its least time and every time, in ms); exits 1 if a variant disagrees and
2 if one does not build or there is no card.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build(directory, variants):
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
        regs = chip_smoke.ptxas_report({name: log})[name]
        print(json.dumps(dict(variant=name, rc=proc.returncode, ptxas={
            k: r for k, r in regs.items() if '<64,' in k})), flush=True)
        if proc.returncode:
            print(log[-4000:], file=sys.stderr)
            raise SystemExit(2)
        libs[name] = ctypes.CDLL(lib)
    return libs


def measure(libs, kernel, dh_arg, scale_arg, reps):
    """One JSON line per shape of phase 13 for ``kernel`` ('dq' or 'dkv')
    at head width ``dh_arg`` and ``scale_arg`` (None: the shape's own dh
    and dh^-0.5). Returns whether every variant passed its checks."""
    import torch
    import chip_smoke
    from paddle_tpu_torch.ops import attention_ops as A
    n_out = 1 if kernel == 'dq' else 2
    fns = {}
    for name, lib in libs.items():
        fn = getattr(lib, 'ptt_flash_attn_bf16_bwd_' + kernel)
        fn.argtypes = [ctypes.c_void_p] * (7 + n_out) + [ctypes.c_int64] * 4 \
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    order = list(fns) + list(reversed(list(fns)))
    dev = torch.device('cuda', 0)
    g = torch.Generator(device=dev).manual_seed(777)
    ok = True
    for sh in chip_smoke.flash_shapes(torch, True):
        B, H, L, dh, causal, bias = (sh[k] for k in (
            'B', 'H', 'L', 'dh', 'causal', 'bias'))
        bias = None if bias is None else bias.to(dev)
        dh = dh_arg or dh
        bh = B * H
        scale = dh ** -0.5 if scale_arg is None else scale_arg
        q, k, v, do = (torch.randn((bh, L, dh), generator=g, device=dev)
                       .to(torch.bfloat16) for _ in range(4))
        fwd = (scale, causal, bias, H)
        o, lse = A._flash_fwd(q, k, v, *fwd)
        ins = (q, k, v, do, lse, A._delta(do, o))
        want = (A._bwd_dq_ref(*ins, *fwd),) if kernel == 'dq' \
            else A._bwd_dkv_ref(*ins, *fwd)
        _, keep = A._scores(q, k, scale, causal, bias, H)
        # the rows (dQ) or keys (dK, dV) that keep nothing
        dead = (~keep.any(dim=2 if kernel == 'dq' else 1)).expand(bh, L)
        del keep
        outs = [torch.empty_like(q) for _ in range(n_out)]
        ptrs = [t.data_ptr() for t in ins] + \
            [0 if bias is None else bias.data_ptr()] + \
            [t.data_ptr() for t in outs]
        res = dict(shape=sh['shape'], kernel=kernel, dh=dh,
                   scale=scale)
        times = {name: [] for name in fns}
        for _ in range(reps):
            for name in order:
                def call(fn=fns[name], name=name):
                    rc = fn(*ptrs, bh, L, dh, H, scale, int(causal),
                            torch.cuda.current_stream().cuda_stream)
                    if rc:
                        raise RuntimeError('%s: CUDA error %d' % (name, rc))
                if name not in res:
                    call()
                    first = [t.clone() for t in outs]
                    call()
                    torch.cuda.synchronize()
                    res[name] = dict(
                        rel_err=max(float((t.float() - w.float()).abs().max()
                                          / w.float().abs().max())
                                    for t, w in zip(outs, want)),
                        rms_err=max(float(
                            (t.float() - w.float()).pow(2).mean().sqrt()
                            / w.float().pow(2).mean().sqrt())
                            for t, w in zip(outs, want)),
                        same=all(torch.equal(f, t)
                                 for f, t in zip(first, outs)),
                        dead_zero=not any(bool(t[dead].any()) for t in outs))
                times[name].append(chip_smoke.cuda_ms(torch, call, calls=10,
                                                      replays=5))
        for name, ts in times.items():
            r = res[name]
            r.update(ms=min(ts), all=ts)
            ok = ok and r['rel_err'] <= 1e-2 and r['same'] and r['dead_zero']
        print(json.dumps(res), flush=True)
        del q, k, v, do, o, lse, ins, want, outs, dead
        torch.cuda.empty_cache()
    return ok


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Build and time variants of the bf16 flash backward.')
    parser.add_argument('dir', help='directory of the variant sources')
    parser.add_argument('variants',
                        help='JSON {name: "file.cu [nvcc flags]"}')
    parser.add_argument('--kernel', choices=('dq', 'dkv', 'both'),
                        default='dq')
    parser.add_argument('--reps', type=int, default=2)
    parser.add_argument('--dh', default='',
                        help='comma-separated head widths, one run each')
    parser.add_argument('--scale', default='',
                        help='comma-separated scales, one for each --dh')
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print('flash_bf16_variants: needs a CUDA card', file=sys.stderr)
        return 2
    dhs = [int(x) for x in args.dh.split(',') if x] or [None]
    scales = [float(x) for x in args.scale.split(',') if x] or \
        [None] * len(dhs)
    if len(scales) != len(dhs):
        parser.error('--scale needs one value for each --dh')
    libs = build(os.path.abspath(args.dir), json.loads(args.variants))
    kernels = ('dq', 'dkv') if args.kernel == 'both' else (args.kernel,)
    ok = True
    for kernel in kernels:
        for dh, scale in zip(dhs, scales):
            ok = measure(libs, kernel, dh, scale, args.reps) and ok
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
