"""paddle_tpu_torch: the PyTorch + CUDA port of paddle_tpu for an NVIDIA
H100.

It ports the Fluid front end: a ``Program`` built with ``layers``,
``optimizer.SGD``/``Adam(...).minimize(loss)`` and
``Executor().run(program, feed=..., fetch_list=...)``, with ``bind`` and
``run_fused`` replaying a CUDA graph of the run plan, and ``io``'s save
and load functions (so ``import paddle_tpu_torch as fluid`` runs the JAX
package's quick start and `models.transformer.build_lm` on the card);
the flagship causal LM's
continuous-batching decode engine (``serving.GenerateEngine``), its
training step as a model (``models.transformer.TransformerLM.loss`` with
``optimizer.TensorAdam``) and BERT-base pretraining
(``models.bert.BertPretrain``), with hand-written CUDA kernels for the
embedding gather, the fused residual-add + LayerNorm (forward and
backward), flash attention (forward, dQ and dK/dV, with the key-padding
bias), the FFN tail, the softmax cross-entropy (forward and backward) and
multi-tensor Adam: one for each Pallas kernel of the JAX package; and bf16
mixed-precision training (``contrib.mixed_precision``) with the bf16 form
of the three flash kernels. The JAX package ``paddle_tpu`` stays the
reference; this package imports ``torch`` and numpy only, never ``jax`` or
``paddle_tpu``.

Entry points run on ``cuda:0`` unless the caller passes ``device='cpu'``
(or ``CPUPlace()``).
"""
from . import initializer, layers, optimizer, unique_name
from .backward import append_backward
from .executor import Executor, Scope, global_scope, scope_guard
from .framework import (CPUPlace, CUDAPlace, Parameter, Program, Variable,
                        default_main_program, default_startup_program,
                        program_guard, resolve_device)
from .ops.kernel_tier import launch_counts, reset_counts
from .param_attr import ParamAttr
from . import io

__all__ = ['CPUPlace', 'CUDAPlace', 'resolve_device', 'launch_counts',
           'reset_counts', 'Program', 'Variable', 'Parameter',
           'default_main_program', 'default_startup_program',
           'program_guard', 'Executor', 'Scope', 'global_scope',
           'scope_guard', 'ParamAttr', 'append_backward', 'layers',
           'optimizer', 'initializer', 'unique_name', 'io']
