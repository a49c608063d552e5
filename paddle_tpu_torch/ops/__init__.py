"""The port's ops: each module holding a CUDA kernel keeps its plain
PyTorch version beside it (ops/kernel_tier.py states the dispatch rule).
Importing the package registers every program op's lowering
(core/registry.py) with the module that holds it."""
from . import (activations, attention_ops, compare_ops,  # noqa: F401
               control_flow_ops, conv_ops, embedding_ops, ffn_ops, math_ops, meta, metrics_ops, nn_ops,
               optimizer_ops, random_ops, rnn_ops, sequence_ops,
               tensor_ops)
