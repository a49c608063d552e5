#!/usr/bin/env python3
"""Build variants of the wide flash source and time their forward, dQ and
dK/dV on one GPU, in turns.

    python3 tools/flash_wide_variants.py DIR '{"name": "file.cu [nvcc flags]"}'
        [--reps N] [--shapes NAME,...] [--kernels fwd,dq,dkv]

A variant is a copy of ``paddle_tpu_torch/csrc/flash_attn_wide.cu`` under
DIR (an earlier commit's, e.g. ``git show <commit>:paddle_tpu_torch/csrc/
flash_attn_wide.cu``, or this one's changed by hand): a comparison or an
ablation lives in such a copy, never as a switch in csrc/. The headers it
includes are found beside it or in csrc/. Every variant exports the same C
entry points (``ptt_flash_wide_fwd``, ``_bwd_dq``, ``_bwd_dkv`` and their
``ptt_flash_wide_bf16_`` forms). nvcc builds them all at once with the
port's own flags (``native.NVCC_FLAGS``: sm_90a, -O3, -Xptxas -v), one
shared library each in DIR.

At each shape (`SHAPES`: chip_smoke.py's phase 13c, BH 64, L 512, dh 512,
causal; dh 1024 at BH 32, the same product flops; and the ``flash_wide``
path's call, BH 4 at dh 512; ``--shapes`` takes some of them), dtype (f32,
then bf16) and kernel (``--kernels``), each variant's kernel is first held
to its plain version (``attention_ops._attention_ref``: f32 O and LSE
within 1e-4 absolute, bf16 O within 1e-2 of its largest magnitude and LSE
within 1e-5; ``_bwd_dq_ref`` and ``_bwd_dkv_ref``, from the plain
forward's LSE and delta: each gradient within 1e-4 (f32) or 1e-2 (bf16) of
its largest magnitude, as tests/test_torch_cuda.py's ``_check_wide``
holds them), and two calls must give the same bits. Then each variant's
launch is timed by CUDA-graph replays (``chip_smoke.cuda_ms``) in the
order given and back again, ``--reps`` times, so that two variants
alternate (a, b, b, a); the plain version and SDPA (whichever backend
takes the width, named by its kernels; for dQ and dK/dV its backward,
which computes dQ, dK and dV in one call; null where none does) are timed
once beside them.

Prints one JSON line per build (each instantiation's registers and spilled
bytes) and one per shape, dtype and kernel: each variant's errors, its
least time, every time and its share of the bound (``chip_smoke.bound``:
the products, 4·dh flops a visible pair forward, 6·dh for dQ and 8·dh for
dK/dV, at the tensor-core rate, against the operands read and the outputs
written once), with the card's name and power limit. Exits 1 if a variant
disagrees and 2 if one does not build or there is no card.
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

# kernel: (entry point suffix, pointer arguments, product flops a visible
# pair per dh, [BH, L, dh] operands read or written, [BH, L] rows)
KERNELS = {'fwd': ('_fwd', 6, 4, 4, 1),
           'dq': ('_bwd_dq', 8, 6, 5, 2),
           'dkv': ('_bwd_dkv', 9, 8, 6, 2)}


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
        print(json.dumps(dict(variant=name, rc=proc.returncode,
                              ptxas=regs)), flush=True)
        if proc.returncode:
            print(log[-4000:], file=sys.stderr)
            raise SystemExit(2)
        libs[name] = ctypes.CDLL(lib)
    return libs


def entry(lib, dtype, kernel):
    """The C entry point of ``kernel`` in ``lib`` for ``dtype`` operands."""
    import torch
    suffix, pointers = KERNELS[kernel][:2]
    fn = getattr(lib, ('ptt_flash_wide' if dtype == torch.float32
                       else 'ptt_flash_wide_bf16') + suffix)
    fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int64] * 4 + \
        [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def sdpa_ms(torch, q, k, v, do, bh, L, dh, causal, backward):
    """(ms, kernel names) of one SDPA call (``backward``: one backward,
    dQ, dK and dV) on the same operands as [1, BH, L, dh], or (None, None)
    where no backend takes them."""
    import chip_smoke
    F = torch.nn.functional
    q4, k4, v4, do4 = (t.view(1, bh, L, dh) for t in (q, k, v, do))

    def sdpa(a, b, c):
        return F.scaled_dot_product_attention(a, b, c, is_causal=causal)
    try:
        if not backward:
            sdpa(q4, k4, v4)
            torch.cuda.synchronize()
            return (chip_smoke.cuda_ms(torch, lambda: sdpa(q4, k4, v4),
                                       calls=10, replays=5),
                    chip_smoke.kernel_names(torch,
                                            lambda: sdpa(q4, k4, v4)))
        leaves = [t.detach().clone().requires_grad_() for t in (q4, k4, v4)]
        out = sdpa(*leaves)
        ms = chip_smoke.backward_ms(torch, sdpa, (q4, k4, v4), do4)
        names = chip_smoke.kernel_names(torch, lambda: torch.autograd.grad(
            out, leaves, do4, retain_graph=True))
        return ms, names
    except RuntimeError:
        return None, None


def measure(libs, shapes, kernels, reps, card):
    """One JSON line per shape of ``shapes``, dtype and kernel of
    ``kernels``. Returns whether every variant passed its checks."""
    import torch
    import chip_smoke
    from paddle_tpu_torch.ops import attention_ops as A
    dev = torch.device('cuda', 0)
    g = torch.Generator(device=dev).manual_seed(2424)
    ok = True
    for shape, bh, L, dh, causal in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            low = dtype == torch.bfloat16
            q, k, v, do = (torch.randn((bh, L, dh), generator=g, device=dev)
                           .to(dtype) for _ in range(4))
            scale = dh ** -0.5
            args = (scale, causal)
            o_ref, lse_ref = A._attention_ref(q, k, v, *args)
            delta = A._delta(do, o_ref)
            ins = (q, k, v, do, lse_ref, delta)
            pairs = bh * L * (L + 1) // 2 if causal else bh * L * L
            mat, row = bh * L * dh * (2 if low else 4), bh * L * 4
            bwd_lib = None
            for kernel in kernels:
                _, _, per_pair, mats, rows = KERNELS[kernel]
                if kernel == 'fwd':
                    outs = (torch.empty_like(q), torch.empty(
                        (bh, L), dtype=torch.float32, device=dev))
                    ptrs = (q, k, v, None) + outs
                    refs = (o_ref, lse_ref)
                    plain = lambda: A._attention_ref(q, k, v, *args)  # noqa
                elif kernel == 'dq':
                    outs = (torch.empty_like(q),)
                    ptrs = ins + (None,) + outs
                    refs = (A._bwd_dq_ref(*ins, *args),)
                    plain = lambda: A._bwd_dq_ref(*ins, *args)  # noqa
                else:
                    outs = (torch.empty_like(k), torch.empty_like(v))
                    ptrs = ins + (None,) + outs
                    refs = A._bwd_dkv_ref(*ins, *args)
                    plain = lambda: A._bwd_dkv_ref(*ins, *args)  # noqa
                flops = per_pair * dh * pairs
                res = dict(shape=shape, kernel=kernel,
                           dtype='bfloat16' if low else 'float32', bh=bh,
                           L=L, dh=dh, causal=causal, visible_pairs=pairs,
                           product_flops=flops, card=card,
                           **chip_smoke.bound(mats * mat + rows * row, 0, **{
                               'bf16_flops' if low else 'product_flops':
                               flops}))
                fns = {name: entry(lib, dtype, kernel)
                       for name, lib in libs.items()}
                times = {name: [] for name in fns}
                order = list(fns) + list(reversed(list(fns)))
                for _ in range(reps):
                    for name in order:
                        def call(fn=fns[name], name=name):
                            rc = fn(*[0 if t is None else t.data_ptr()
                                      for t in ptrs], bh, L, dh, 1, scale,
                                    int(causal),
                                    torch.cuda.current_stream().cuda_stream)
                            if rc:
                                raise RuntimeError('%s: CUDA error %d'
                                                   % (name, rc))
                        if name not in res:
                            res[name] = check(torch, call, outs, refs,
                                              kernel, low)
                        times[name].append(chip_smoke.cuda_ms(
                            torch, call, calls=3, replays=3))
                for name, ts in times.items():
                    r = res[name]
                    r.update(ms=min(ts), all=ts,
                             share_of_bound=res['bound_ms'] / min(ts))
                    ok = ok and r['right']
                res['plain_ms'] = chip_smoke.cuda_ms(torch, plain, calls=2,
                                                     replays=3)
                if kernel == 'fwd':
                    lib_ms = sdpa_ms(torch, q, k, v, do, bh, L, dh, causal,
                                     False)
                else:
                    bwd_lib = bwd_lib or sdpa_ms(torch, q, k, v, do, bh, L,
                                                 dh, causal, True)
                    lib_ms = bwd_lib
                res['library_ms'], res['library_kernels'] = lib_ms
                print(json.dumps(res), flush=True)
                del outs, refs, ptrs
            del q, k, v, do, o_ref, lse_ref, delta, ins
            torch.cuda.empty_cache()
    return ok


def check(torch, call, outs, refs, kernel, low):
    """Two calls against the plain outputs ``refs``: errors, whether the
    bits repeat, and whether the kernel is right (module docstring)."""
    call()
    first = [t.clone() for t in outs]
    call()
    torch.cuda.synchronize()
    errs = [float((o.float() - r.float()).abs().max())
            for o, r in zip(outs, refs)]
    tops = [float(r.float().abs().max()) for r in refs]
    same = all(torch.equal(a, b) for a, b in zip(first, outs))
    if kernel == 'fwd':
        r = dict(o_err=errs[0], o_rel_err=errs[0] / tops[0],
                 lse_err=errs[1], same=same)
        r['right'] = same and ((r['o_rel_err'] <= 1e-2 and errs[1] <= 1e-5)
                               if low else max(errs) <= 1e-4)
        return r
    tol = 1e-2 if low else 1e-4
    r = dict(errs=errs, rel_errs=[e / t for e, t in zip(errs, tops)],
             same=same)
    r['right'] = same and all(e <= tol * max(1.0, t)
                              for e, t in zip(errs, tops))
    return r


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Build and time variants of the wide flash kernels.')
    parser.add_argument('dir', help='directory of the variant sources')
    parser.add_argument('variants',
                        help='JSON {name: "file.cu [nvcc flags]"}')
    parser.add_argument('--reps', type=int, default=2)
    parser.add_argument('--shapes', default='',
                        help='comma-separated names from SHAPES (all)')
    parser.add_argument('--kernels', default='fwd,dq,dkv',
                        help='comma-separated names from KERNELS')
    args = parser.parse_args(argv)
    kernels = [k for k in args.kernels.split(',') if k]
    if any(k not in KERNELS for k in kernels):
        parser.error('--kernels takes %s' % ','.join(KERNELS))
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
    return 0 if measure(libs, shapes, kernels, args.reps, card) else 1


if __name__ == '__main__':
    sys.exit(main())
