"""The decoder API (the port's own copy of paddle_tpu/contrib/decoder,
the reference's python/paddle/fluid/contrib/decoder/)."""
from .beam_search_decoder import (InitState, StateCell, TrainingDecoder,
                                  BeamSearchDecoder)

__all__ = ['InitState', 'StateCell', 'TrainingDecoder',
           'BeamSearchDecoder']
