"""char-LSTM language model symbols (example/rnn/lstm.py + char-rnn), as
the JAX package's ``models/lstm.py`` builds them.

``get_symbol`` runs the layers as one ``RNN`` node through
``rnn.FusedRNNCell`` (cuDNN's RNN on the card); ``get_unfused_symbol``
unrolls ``rnn.LSTMCell``s step by step (with ``DropoutCell``s between
layers when ``dropout`` > 0).
"""
from .. import symbol as sym
from .. import rnn


def get_symbol(seq_len, vocab_size, num_hidden=256, num_embed=128,
               num_layers=2, dropout=0.0, **kwargs):
    cell = rnn.FusedRNNCell(num_hidden, num_layers=num_layers, mode="lstm",
                            dropout=dropout, prefix="lstm_")
    data = sym.Variable("data")
    embed = sym.Embedding(data, input_dim=vocab_size, output_dim=num_embed,
                          name="embed")
    output, _ = cell.unroll(seq_len, inputs=embed, layout="NTC",
                            merge_outputs=True)
    pred = sym.Reshape(output, shape=(-1, num_hidden))
    pred = sym.FullyConnected(pred, num_hidden=vocab_size, name="pred")
    label = sym.Reshape(sym.Variable("softmax_label"), shape=(-1,))
    return sym.SoftmaxOutput(pred, label, name="softmax")


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
