"""Operator implementations; importing this package registers them."""
from . import (nn, conv, matrix, elemwise, optimizer_ops,  # noqa: F401
               broadcast, init_ops, sample, rnn_op, contrib, detection,
               sequence_loss)
