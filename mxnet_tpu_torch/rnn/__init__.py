"""RNN toolkit (PyTorch counterpart of ``mxnet_tpu/rnn``): the cells,
fused and unfused, that build unrolled symbol graphs, and the bucketed
sentence iterator."""
from .rnn_cell import (RNNParams, BaseRNNCell, RNNCell, LSTMCell,  # noqa
                       GRUCell, FusedRNNCell, SequentialRNNCell,
                       BidirectionalCell, DropoutCell, ModifierCell,
                       ZoneoutCell, ResidualCell)
from .io import BucketSentenceIter, encode_sentences  # noqa

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell", "BidirectionalCell",
           "DropoutCell", "ModifierCell", "ZoneoutCell", "ResidualCell",
           "BucketSentenceIter", "encode_sentences"]
