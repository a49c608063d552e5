"""paddle_tpu_torch: the PyTorch + CUDA port of paddle_tpu for an NVIDIA
H100.

It ports the flagship causal LM's continuous-batching decode engine
(``serving.GenerateEngine``), its training step
(``models.transformer.TransformerLM.loss`` with ``optimizer.Adam``) and
BERT-base pretraining (``models.bert.BertPretrain``), with hand-written
CUDA kernels for the embedding gather, the fused residual-add + LayerNorm
(forward and backward), flash attention (forward, dQ and dK/dV, with the
key-padding bias), the FFN tail, the softmax cross-entropy (forward and
backward) and multi-tensor Adam: one for each Pallas kernel of the JAX
package. The JAX package ``paddle_tpu`` stays the reference; this
package imports ``torch`` and numpy only, never ``jax`` or ``paddle_tpu``.

Entry points run on ``cuda:0`` unless the caller passes ``device='cpu'``.
"""
from .framework import CPUPlace, CUDAPlace, resolve_device
from .ops.kernel_tier import launch_counts, reset_counts

__all__ = ['CPUPlace', 'CUDAPlace', 'resolve_device', 'launch_counts',
           'reset_counts']
