"""paddle_tpu_torch stands alone: no module of the port, and not
chip_smoke.py, imports jax, jaxlib or paddle_tpu (whole top-level names:
``paddle_tpu_torch`` itself starts with ``paddle_tpu``), every module
imports with those blocked, and entry points default to the card."""
import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, 'paddle_tpu_torch')
FORBIDDEN = {'jax', 'jaxlib', 'paddle_tpu'}


def _sources():
    out = [os.path.join(ROOT, 'chip_smoke.py')]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith('.py')]
    return sorted(out)


def _modules():
    mods = []
    for path in _sources()[1:]:
        rel = os.path.relpath(path, ROOT)[:-3].split(os.sep)
        if rel[-1] == '__init__':
            rel = rel[:-1]
        mods.append('.'.join(rel))
    return mods


def _top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split('.')[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split('.')[0])
    return names


@pytest.mark.parametrize('path', _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_paddle_tpu_import(path):
    assert not _top_level_imports(path) & FORBIDDEN


def test_every_module_imports_with_jax_and_paddle_tpu_blocked():
    code = '''
import importlib, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in %r:
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
for m in %r:
    importlib.import_module(m)
leaked = sorted(m for m in sys.modules if m.split('.')[0] in %r)
assert not leaked, leaked
print('ok', len(%r))
''' % (sorted(FORBIDDEN), _modules(), sorted(FORBIDDEN), _modules())
    res = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith('ok')


def test_entry_point_defaults_to_cuda_and_raises_without_a_card():
    from paddle_tpu_torch import resolve_device
    from paddle_tpu_torch.models.transformer import LMConfig
    from paddle_tpu_torch.serving import GenerateConfig, GenerateEngine
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the default device is usable')
    cfg = GenerateConfig(model=LMConfig(vocab_size=32, d_model=32, n_head=2,
                                        n_layer=1, d_ff=64),
                         max_len=16, prompt_buckets=[8])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GenerateEngine(cfg)
    with pytest.raises(RuntimeError, match='none is available'):
        resolve_device('cuda')
    assert resolve_device('cpu') == torch.device('cpu')


def test_chip_smoke_fails_without_a_card():
    """chip_smoke.py exits non-zero and prints no result line here."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    res = subprocess.run([sys.executable, os.path.join(ROOT, 'chip_smoke.py')],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_kernel_build_raises_without_nvcc(monkeypatch):
    """No nvcc means no kernels: the build raises instead of falling back
    (here, on a box without the CUDA toolkit)."""
    import shutil
    from paddle_tpu_torch import native
    monkeypatch.delenv('CUDA_HOME', raising=False)
    monkeypatch.delenv('CUDA_PATH', raising=False)
    if shutil.which('nvcc') or os.path.exists('/usr/local/cuda/bin/nvcc'):
        pytest.skip('nvcc is installed here')
    with pytest.raises(native.BuildError, match='nvcc not found'):
        native.build()


def test_library_name_hashes_the_headers_a_source_includes(tmp_path,
                                                            monkeypatch):
    """Editing a header renames the library of every source that includes
    it, and of no other, so a stale kernel is never loaded; the three
    tensor-core sources include the shared 3xTF32 header."""
    from paddle_tpu_torch import native
    for name in ('flash_attn_fwd', 'flash_attn_bwd', 'ffn_gemm'):
        with open(os.path.join(native.CSRC, name + '.cu'), 'rb') as f:
            assert native._INCLUDE.findall(f.read()) == [b'tf32_mma.cuh']
    (tmp_path / 'a.cu').write_text('#include "h.cuh"\n#include <stdint.h>\n')
    (tmp_path / 'b.cu').write_text('#include <stdint.h>\n')
    (tmp_path / 'h.cuh').write_text('// one\n')
    monkeypatch.setattr(native, 'CSRC', str(tmp_path))
    before = {n: native._lib_path(n)[1] for n in 'ab'}
    (tmp_path / 'h.cuh').write_text('// two\n')
    after = {n: native._lib_path(n)[1] for n in 'ab'}
    assert before['a'] != after['a']
    assert before['b'] == after['b']
