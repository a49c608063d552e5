"""Layers: functions that append ops (and parameters) to the default
programs.

The port's own copy of the parts of paddle_tpu/layers that this slice's
programs call: the flagship LM's `build_lm` (training and inference),
BERT's `build_bert_pretrain`, the image models' `build` (ResNet,
SE-ResNeXt, VGG), the README's quick start, and the sequence models
(the sequence ops, ``dynamic_lstm``, ``dynamic_gru``), and the op
library's shape, cast, compare and reduce layers, and the control flow
(``control_flow``: the comparisons, ``While``, ``StaticRNN``,
``DynamicRNN``, ``ConditionalBlock``, ``Switch``, ``IfElse``, the tensor
arrays and beam search). Each
layer emits the JAX layer's op, letter for letter (type, input and output
slots, attrs); the rest of the JAX layers wait for later slices.
``math_op_patch`` holds the ops behind ``Variable``'s operators, and
``learning_rate_scheduler`` the schedules, also reachable as
``layers.learning_rate_scheduler.noam_decay`` as in the JAX package.
"""
from . import io
from . import tensor
from . import nn
from . import ops
from . import metric_op
from . import sequence
from . import rnn
from . import control_flow
from . import math_op_patch
from . import learning_rate_scheduler

from .io import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .metric_op import *  # noqa: F401,F403
from .sequence import *  # noqa: F401,F403
from .rnn import *  # noqa: F401,F403
from .control_flow import *  # noqa: F401,F403
from .learning_rate_scheduler import *  # noqa: F401,F403

__all__ = []
__all__ += io.__all__
__all__ += tensor.__all__
__all__ += nn.__all__
__all__ += ops.__all__
__all__ += metric_op.__all__
__all__ += sequence.__all__
__all__ += rnn.__all__
__all__ += control_flow.__all__
__all__ += learning_rate_scheduler.__all__
