"""char-LSTM language model symbols (example/rnn/lstm.py + char-rnn), as
the JAX package's ``models/lstm.py`` builds them.

``get_unfused_symbol`` unrolls ``rnn.LSTMCell``s (with ``DropoutCell``s
between layers when ``dropout`` > 0). ``get_symbol`` needs
``FusedRNNCell`` and the ``RNN`` operator, which come with the rnn slice
of the port: it raises ``MXNetError`` until then.
"""
from .. import symbol as sym
from .. import rnn
from ..base import MXNetError


def get_symbol(seq_len, vocab_size, num_hidden=256, num_embed=128,
               num_layers=2, dropout=0.0, **kwargs):
    raise MXNetError("lstm.get_symbol needs FusedRNNCell and the RNN "
                     "operator, which come with the rnn slice of the port "
                     "(ROADMAP A6); use get_unfused_symbol")


def get_unfused_symbol(seq_len, vocab_size, num_hidden=256, num_embed=128,
                       num_layers=2, dropout=0.0, **kwargs):
    stack = rnn.SequentialRNNCell()
    for i in range(num_layers):
        stack.add(rnn.LSTMCell(num_hidden, prefix="lstm_l%d_" % i))
        if dropout > 0 and i < num_layers - 1:
            stack.add(rnn.DropoutCell(dropout, prefix="lstm_d%d_" % i))
    data = sym.Variable("data")
    embed = sym.Embedding(data, input_dim=vocab_size, output_dim=num_embed,
                          name="embed")
    outputs, _ = stack.unroll(seq_len, inputs=embed, layout="NTC",
                              merge_outputs=True)
    pred = sym.Reshape(outputs, shape=(-1, num_hidden))
    pred = sym.FullyConnected(pred, num_hidden=vocab_size, name="pred")
    label = sym.Reshape(sym.Variable("softmax_label"), shape=(-1,))
    return sym.SoftmaxOutput(pred, label, name="softmax")
