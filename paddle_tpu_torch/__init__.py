"""paddle_tpu_torch: the PyTorch + CUDA port of paddle_tpu for an NVIDIA
H100.

It ports the Fluid front end: a ``Program`` built with ``layers`` and
``nets``, ``optimizer.SGD``/``Momentum``/``Adam(...).minimize(loss)`` (with
``regularizer`` weight decay and ``clip`` gradient clipping) and
``Executor().run(program, feed=..., fetch_list=...)``, ``calc_gradient``
(alias ``gradients``) w.r.t. fed variables or parameters, with ``bind`` and
``run_fused`` replaying a CUDA graph of the run plan, and ``io``'s save
and load functions (so ``import paddle_tpu_torch as fluid`` runs the JAX
package's quick start and `models.transformer.build_lm` on the card);
the deploy path (``io.save_inference_model`` prunes a program for
inference, ``create_predictor`` serves it) with the image classifiers as
programs (``models.resnet``, ``models.se_resnext``, ``models.vgg``:
conv2d, batch_norm, pool2d), trained under bf16 AMP with
``keep_bf16_activations``; ragged (LoD) sequences (``(array, lod)``
feeds, ``create_lod_tensor``, ``DataFeeder``) through the sequence ops
and ``layers.dynamic_lstm``/``dynamic_gru``; control flow (``While``,
``StaticRNN``, ``DynamicRNN``, ``ConditionalBlock``, ``Switch``,
``IfElse``, tensor arrays, beam search) with the attention seq2seq model
(``models.seq2seq``) and the decoders (``contrib.decoder``); the flagship
causal LM's
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
from . import clip, nets, regularizer
from .backward import append_backward, calc_gradient, gradients
from .executor import Executor, Scope, global_scope, scope_guard
from .framework import (Block, CPUPlace, CUDAPlace, Operator, Parameter,
                        Program, Variable, cpu_places, cuda_places,
                        default_main_program, default_startup_program,
                        program_guard, resolve_device)
from .ops.kernel_tier import launch_counts, reset_counts
from .param_attr import ParamAttr
from . import io
from .io import (load_inference_model, load_params, load_persistables,
                 load_vars, save_inference_model, save_params,
                 save_persistables, save_vars)
from . import inference
from .inference import Predictor, PredictorConfig, create_predictor
from . import lod_tensor
from .lod_tensor import (LoDTensor, create_lod_tensor,
                         create_random_int_lodtensor)
from .data_feeder import DataFeeder

__all__ = ['CPUPlace', 'CUDAPlace', 'cpu_places', 'cuda_places',
           'resolve_device', 'launch_counts', 'reset_counts', 'Program',
           'Block', 'Operator', 'Variable', 'Parameter',
           'default_main_program', 'default_startup_program',
           'program_guard', 'Executor', 'Scope', 'global_scope',
           'scope_guard', 'ParamAttr', 'append_backward', 'calc_gradient',
           'gradients', 'layers',
           'optimizer', 'initializer', 'unique_name', 'io', 'clip',
           'nets', 'regularizer',
           'save_inference_model', 'load_inference_model', 'save_vars',
           'save_params', 'save_persistables', 'load_vars', 'load_params',
           'load_persistables', 'inference',
           'PredictorConfig', 'Predictor', 'create_predictor',
           'lod_tensor', 'LoDTensor', 'create_lod_tensor',
           'create_random_int_lodtensor', 'DataFeeder']
