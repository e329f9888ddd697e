"""RNN cells (PyTorch counterpart of ``mxnet_tpu/rnn``): the unfused
cells that build an unrolled symbol graph step by step."""
from .rnn_cell import (RNNParams, BaseRNNCell, RNNCell, LSTMCell,  # noqa
                       GRUCell, SequentialRNNCell, DropoutCell)

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "SequentialRNNCell", "DropoutCell"]
