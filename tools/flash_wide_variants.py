#!/usr/bin/env python3
"""Build variants of the wide flash source and time their forward on one
GPU, in turns.

    python3 tools/flash_wide_variants.py DIR '{"name": "file.cu [nvcc flags]"}'
        [--reps N] [--shapes NAME,...]

A variant is a copy of ``paddle_tpu_torch/csrc/flash_attn_wide.cu`` under
DIR (an earlier commit's, e.g. ``git show <commit>:paddle_tpu_torch/csrc/
flash_attn_wide.cu``, or this one's changed by hand): a comparison or an
ablation lives in such a copy, never as a switch in csrc/. The headers it
includes are found beside it or in csrc/. Every variant exports the same C
entry points, ``ptt_flash_wide_fwd`` and ``ptt_flash_wide_bf16_fwd``. nvcc
builds them all at once with the port's own flags (``native.NVCC_FLAGS``:
sm_90a, -O3, -Xptxas -v), one shared library each in DIR.

At each shape (`SHAPES`: chip_smoke.py's phase 13c, BH 64, L 512, dh 512,
causal; dh 1024 at BH 32, the same product flops; and the ``flash_wide``
path's call, BH 4 at dh 512; ``--shapes`` takes some of them) and dtype
(f32, then bf16), each variant's forward is first held to the plain version
(``attention_ops._attention_ref``; f32: O and LSE within 1e-4 absolute;
bf16: O within 1e-2 of its largest magnitude, LSE within 1e-5), and two
calls must give the same bits. Then each variant's launch is timed by
CUDA-graph replays (``chip_smoke.cuda_ms``) in the order given and back
again, ``--reps`` times, so that two variants alternate (a, b, b, a); the
plain version and SDPA (whichever backend takes the width, named by its
kernels; null where none does) are timed once beside them.

Prints one JSON line per build (each forward instantiation's registers and
spilled bytes) and one per shape and dtype: each variant's errors, its
least time, every time and its share of the bound (``chip_smoke.bound``:
the products, 4·dh flops a visible pair, at the tensor-core rate, against
q, k, v and o read or written once), with the card's name and power limit.
Exits 1 if a variant disagrees and 2 if one does not build or there is no
card.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (name, BH, L, dh, causal)
SHAPES = (('phase13c_dh512', 64, 512, 512, True),
          ('dh1024', 32, 512, 1024, True),
          ('flash_wide_bh4', 4, 512, 512, True))


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
            [native.nvcc_path(), *native.NVCC_FLAGS, '-I', native.CSRC,
             '-o', lib, os.path.join(directory, src), *flags],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0].decode(errors='replace')
        regs = chip_smoke.ptxas_report({name: log})[name]
        print(json.dumps(dict(variant=name, rc=proc.returncode, ptxas={
            k: r for k, r in regs.items() if 'fwd' in k})), flush=True)
        if proc.returncode:
            print(log[-4000:], file=sys.stderr)
            raise SystemExit(2)
        libs[name] = ctypes.CDLL(lib)
    return libs


def forward(lib, dtype):
    """The forward entry point of ``lib`` for ``dtype`` operands."""
    import torch
    fn = getattr(lib, 'ptt_flash_wide_fwd' if dtype == torch.float32
                 else 'ptt_flash_wide_bf16_fwd')
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 4 + \
        [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def sdpa_ms(torch, q, k, v, bh, L, dh, causal):
    """(ms, kernel names) of one SDPA call on the same operands as
    [1, BH, L, dh], or (None, None) where no backend takes them."""
    import chip_smoke
    F = torch.nn.functional
    q4, k4, v4 = (t.view(1, bh, L, dh) for t in (q, k, v))

    def call():
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)
    try:
        call()
        torch.cuda.synchronize()
    except RuntimeError:
        return None, None
    return (chip_smoke.cuda_ms(torch, call, calls=10, replays=5),
            chip_smoke.kernel_names(torch, call))


def measure(libs, shapes, reps, card):
    """One JSON line per shape of ``shapes`` and dtype. Returns whether
    every variant passed its checks."""
    import torch
    import chip_smoke
    from paddle_tpu_torch.ops import attention_ops as A
    dev = torch.device('cuda', 0)
    g = torch.Generator(device=dev).manual_seed(2424)
    ok = True
    for shape, bh, L, dh, causal in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            low = dtype == torch.bfloat16
            q, k, v = (torch.randn((bh, L, dh), generator=g, device=dev)
                       .to(dtype) for _ in range(3))
            scale = dh ** -0.5
            o_ref, lse_ref = A._attention_ref(q, k, v, scale, causal)
            o, lse = torch.empty_like(q), torch.empty(
                (bh, L), dtype=torch.float32, device=dev)
            pairs = bh * L * (L + 1) // 2 if causal else bh * L * L
            nbytes = 4 * bh * L * dh * (2 if low else 4) + bh * L * 4
            flops = 4 * dh * pairs
            res = dict(shape=shape, dtype='bfloat16' if low else 'float32',
                       bh=bh, L=L, dh=dh, causal=causal, visible_pairs=pairs,
                       product_flops=flops, card=card,
                       **chip_smoke.bound(nbytes, 0, **{
                           'bf16_flops' if low else 'product_flops': flops}))
            fns = {name: forward(lib, dtype) for name, lib in libs.items()}
            times = {name: [] for name in fns}
            order = list(fns) + list(reversed(list(fns)))
            for _ in range(reps):
                for name in order:
                    def call(fn=fns[name], name=name):
                        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), 0,
                                o.data_ptr(), lse.data_ptr(), bh, L, dh, 1,
                                scale, int(causal),
                                torch.cuda.current_stream().cuda_stream)
                        if rc:
                            raise RuntimeError('%s: CUDA error %d'
                                               % (name, rc))
                    if name not in res:
                        call()
                        first = (o.clone(), lse.clone())
                        call()
                        torch.cuda.synchronize()
                        o_err = float((o.float() - o_ref.float()).abs().max())
                        lse_err = float((lse - lse_ref).abs().max())
                        top = float(o_ref.float().abs().max())
                        r = res[name] = dict(
                            o_err=o_err, o_rel_err=o_err / top,
                            lse_err=lse_err,
                            same=torch.equal(first[0], o) and
                            torch.equal(first[1], lse))
                        r['right'] = r['same'] and (
                            (r['o_rel_err'] <= 1e-2 and lse_err <= 1e-5)
                            if low else (o_err <= 1e-4 and lse_err <= 1e-4))
                    times[name].append(chip_smoke.cuda_ms(
                        torch, call, calls=3, replays=3))
            for name, ts in times.items():
                r = res[name]
                r.update(ms=min(ts), all=ts,
                         share_of_bound=res['bound_ms'] / min(ts))
                ok = ok and r['right']
            res['plain_ms'] = chip_smoke.cuda_ms(
                torch, lambda: A._attention_ref(q, k, v, scale, causal),
                calls=2, replays=3)
            res['library_ms'], res['library_kernels'] = sdpa_ms(
                torch, q, k, v, bh, L, dh, causal)
            print(json.dumps(res), flush=True)
            del q, k, v, o, lse, o_ref, lse_ref, first
            torch.cuda.empty_cache()
    return ok


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Build and time variants of the wide flash forward.')
    parser.add_argument('dir', help='directory of the variant sources')
    parser.add_argument('variants',
                        help='JSON {name: "file.cu [nvcc flags]"}')
    parser.add_argument('--reps', type=int, default=2)
    parser.add_argument('--shapes', default='',
                        help='comma-separated names from SHAPES (all)')
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print('flash_wide_variants: needs a CUDA card', file=sys.stderr)
        return 2
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    want = [s for s in args.shapes.split(',') if s]
    shapes = [s for s in SHAPES if not want or s[0] in want]
    libs = build(os.path.abspath(args.dir), json.loads(args.variants))
    return 0 if measure(libs, shapes, args.reps, card) else 1


if __name__ == '__main__':
    sys.exit(main())
