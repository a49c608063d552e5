"""Contributed modules of the port: bf16 mixed precision
(:mod:`.mixed_precision`) and the training and beam-search decoders
(:mod:`.decoder`)."""
from . import decoder
from . import mixed_precision

__all__ = ['decoder', 'mixed_precision']
