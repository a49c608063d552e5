"""Contributed modules of the port: bf16 mixed precision
(:mod:`.mixed_precision`)."""
from . import mixed_precision

__all__ = ['mixed_precision']
