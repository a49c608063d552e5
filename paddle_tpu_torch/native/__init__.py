"""Build and load the port's hand-written CUDA kernels.

Each kernel lives in one source under ``paddle_tpu_torch/csrc/`` with a
plain C interface. At first use ``nvcc`` compiles every source into its own
shared library under ``paddle_tpu_torch/_build/`` (one ``nvcc`` process per
source, all started together), and ``ctypes`` loads it. A library's file
name carries a hash of its source and of the headers it includes (``#include
"x.cuh"`` from ``csrc/``), so an edited kernel or header is rebuilt and a
stale library is never loaded. Nothing here includes PyTorch's headers,
which keeps a build to seconds. ``-Xptxas -v`` makes nvcc report each
kernel's registers, shared memory and spills; :func:`build` returns that
report.

Pointers and the CUDA stream cross the boundary as ``ctypes.c_void_p``
(Python ints from ``Tensor.data_ptr()`` and ``Stream.cuda_stream``); every
C function returns ``cudaGetLastError()`` after its launch, and
:func:`check` raises when that is not 0. A missing ``nvcc`` or a failed
build raises :class:`BuildError`: there is no fallback.
"""
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

__all__ = ['SOURCES', 'BuildError', 'build', 'function', 'check',
           'nvcc_path']

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(_PKG, '_build')

# one shared library per kernel source
SOURCES = ('embedding_gather', 'ln_residual', 'flash_attn_fwd', 'ffn_gemm',
           'softmax_ce', 'fused_adam', 'flash_attn_bwd', 'flash_attn_bf16_fwd',
           'flash_attn_bf16_bwd', 'flash_attn_wide')

NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')
_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)

_lock = threading.Lock()
_libs = {}


class BuildError(RuntimeError):
    """nvcc is missing, or a kernel source failed to compile or load."""


def nvcc_path():
    """The nvcc to build with: $CUDA_HOME/bin/nvcc, else nvcc on PATH,
    else /usr/local/cuda/bin/nvcc. Raises BuildError when none exists."""
    home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH')
    cands = [os.path.join(home, 'bin', 'nvcc')] if home else []
    found = shutil.which('nvcc')
    if found:
        cands.append(found)
    cands.append('/usr/local/cuda/bin/nvcc')
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise BuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels of paddle_tpu_torch are "
        "built from source at first use")


def _lib_path(name):
    src = os.path.join(CSRC, name + '.cu')
    with open(src, 'rb') as f:
        text = f.read()
    digest = hashlib.sha1(text + ' '.join(NVCC_FLAGS).encode())
    for header in _INCLUDE.findall(text):
        with open(os.path.join(CSRC, header.decode()), 'rb') as f:
            digest.update(f.read())
    return src, os.path.join(BUILD_DIR, 'lib%s-%s.so'
                             % (name, digest.hexdigest()[:12]))


def build(names=SOURCES):
    """Compile every listed source whose library is missing, one nvcc
    process each, all running at once. Returns {'seconds', 'built',
    'log'}: the wall time, the sources that were compiled (empty when every
    library already existed) and nvcc's output for each of them (ptxas's
    report of every kernel's registers and spills)."""
    t0 = time.perf_counter()
    todo, log = [], {}
    for name in names:
        src, lib = _lib_path(name)
        if not os.path.exists(lib):
            todo.append((name, src, lib))
    if todo:
        nvcc = nvcc_path()
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = []
        for name, src, lib in todo:
            tmp = '%s.%d.tmp' % (lib, os.getpid())
            p = subprocess.Popen([nvcc] + list(NVCC_FLAGS) + ['-o', tmp, src],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT)
            procs.append((name, lib, tmp, p))
        failed = []
        for name, lib, tmp, p in procs:
            out, _ = p.communicate()
            log[name] = out.decode(errors='replace')
            if p.returncode != 0:
                failed.append('%s.cu (exit %d):\n%s'
                              % (name, p.returncode, log[name]))
                if os.path.exists(tmp):
                    os.remove(tmp)
                continue
            os.replace(tmp, lib)   # atomic: a reader never sees half a file
        if failed:
            raise BuildError('nvcc failed:\n' + '\n'.join(failed))
    return {'seconds': time.perf_counter() - t0,
            'built': [name for name, _, _ in todo],
            'log': log}


def _library(name):
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            build()
            _, path = _lib_path(name)
            try:
                _libs[name] = ctypes.CDLL(path)
            except OSError as e:
                raise BuildError('cannot load %s: %s' % (path, e)) from e
        return _libs[name]


def function(lib_name, fn_name, argtypes):
    """The C function ``fn_name`` of kernel library ``lib_name`` with its
    argument types declared and an int return (the CUDA error code)."""
    fn = getattr(_library(lib_name), fn_name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(rc, what):
    """Raise when a kernel's C entry point returned a CUDA error."""
    if rc != 0:
        raise RuntimeError('%s: CUDA error %d at launch (cudaGetLastError)'
                           % (what, rc))
