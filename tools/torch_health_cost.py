"""The CUDA launches and device ms of the health tier's two device passes
at examples/train_lm.py's shapes (chip_smoke.py's EXAMPLE_LM, B 64): the
``health_stats`` op (ops/health_ops.py) over the 76 gradients, parameters,
pre-update copies and 6 tapped activations, and the ``FLAGS_check_nan_inf``
check (executor.py) over Adam's written state (parameters, both moments,
the powers and the step counter) and the loss. Each pass is counted by
torch.profiler over one call (CUDA kernels, host-to-device copies, device
ms) and timed with CUDA events over 20 calls back to back. Prints one JSON
line with the card's name and power limit.

    python tools/torch_health_cost.py        # on a CUDA card
"""
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import torch
import chip_smoke as cs
from paddle_tpu_torch.executor import _finite_flags
from paddle_tpu_torch.models.transformer import LMConfig, param_shapes
from paddle_tpu_torch.ops.health_ops import health_stats
smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                      '--format=csv,noheader'], capture_output=True,
                     text=True).stdout.strip()
dev = torch.device('cuda')
cfg = LMConfig(**cs.EXAMPLE_LM)
shapes = list(param_shapes(cfg).values())
g = torch.Generator(device='cpu').manual_seed(0)
rand = lambda s: (torch.randn(s, generator=g) * 0.02).to(dev)
grads = [rand(s) for s in shapes]
params = [rand(s) for s in shapes]
pres = [p * 0.999 for p in params]
acts = [rand((cs.EXAMPLE_B, cfg.seq_len, cfg.d_model)) for _ in range(cfg.n_layer)]
loss = torch.ones(1, device=dev)
m1 = [torch.zeros_like(p) for p in params]
m2 = [torch.zeros_like(p) for p in params]
pows = [torch.ones(1, device=dev) for _ in range(2 * len(params))]
state = params + m1 + m2 + pows + [torch.zeros(1, dtype=torch.int64, device=dev)]
fns = {'health_stats': lambda: health_stats(grads, params, pres, acts, loss),
       'check_nan_inf': lambda: _finite_flags(state + [loss], dev)}
out = dict(card=smi, tensors=len(shapes), state_tensors=len(state),
           state_bytes=sum(t.nbytes for t in state))
for name, fn in fns.items():
    fn(); torch.cuda.synchronize()
    copies, kernels, wall_ms, dev_ms = cs.htod_copies(torch, fn)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(20):
        fn()
    e1.record(); torch.cuda.synchronize()
    out[name] = dict(cuda_launches=kernels, htod=copies,
                     profiled_device_ms=dev_ms, ms=e0.elapsed_time(e1) / 20)
print(json.dumps(out))
