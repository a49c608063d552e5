from . import mnist, seq2seq, word2vec
from .bert import BertConfig, BertPretrain
from .transformer import LMConfig, TransformerLM

__all__ = ['BertConfig', 'BertPretrain', 'LMConfig', 'TransformerLM']
