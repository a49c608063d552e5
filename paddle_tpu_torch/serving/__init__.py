from .batcher import (DeadlineExceededError, EngineStoppedError,
                      LoadShedError, ServingError)
from .generate import (GenerateConfig, GenerateEngine, GenerateRequest,
                       GenerateResult)
from .kv_blocks import BlockAllocator, PrefixCache, QuotaBlockAllocator

__all__ = ['GenerateConfig', 'GenerateEngine', 'GenerateRequest',
           'GenerateResult', 'ServingError', 'LoadShedError',
           'DeadlineExceededError', 'EngineStoppedError', 'BlockAllocator',
           'PrefixCache', 'QuotaBlockAllocator']
