"""The recurrent example twins of the PyTorch port on the CPU
(``--cpu``), in process: ``sort_lstm`` (a ``BidirectionalCell`` of
``LSTMCell``s) passes the JAX script's accuracy assert with the epochs
``tests/test_examples.py`` gives the JAX script; ``char_lstm`` (the fused
``models.lstm`` net) and ``bucketing_lstm`` (``BucketingModule`` over
``BucketSentenceIter``) train at cut widths with falling perplexity, the
latter over every bucket of its data, with the per-bucket clock on."""
import torch

from mxnet_tpu_torch.examples import bucketing_lstm, char_lstm, sort_lstm
from mxnet_tpu_torch.ops import rnn_op

torch.set_num_threads(2)


def test_sort_lstm_twin_passes_its_assert():
    res = sort_lstm.main(["--cpu", "--num-epoch", "8"])
    assert res["accuracy"] > 0.85


def test_char_lstm_twin_trains_through_the_rnn_op():
    before = rnn_op.launches
    res = char_lstm.main(["--cpu", "--num-epochs", "2", "--seq-len", "16",
                          "--num-hidden", "64", "--num-embed", "16",
                          "--batch-size", "64"])
    ppl = res["perplexity"]
    assert len(ppl) == 2 and ppl[1] < ppl[0] and ppl[1] < 1.5
    assert res["vocab"] == len(set(char_lstm.SYNTHETIC_TEXT))
    # one RNN call a training step, on the fused route
    assert rnn_op.launches - before == res["steps"]
    assert type(res["module"]._exec_group).__name__ == "MeshExecutorGroup"
    assert all(r["ms_per_step"] > 0 for r in res["epochs"])


def test_bucketing_lstm_twin_trains_every_bucket():
    res = bucketing_lstm.main(["--cpu", "--num-epochs", "2",
                               "--num-hidden", "32", "--num-embed", "16",
                               "--num-layers", "2", "--vocab-size", "200",
                               "--sentences", "600", "--buckets",
                               "10,20,30", "--zipf", "1.2",
                               "--batch-size", "32", "--per-bucket-times"])
    ppl = res["perplexity"]
    assert ppl[1] < ppl[0] < 200
    assert res["buckets_bound"] == [10, 20, 30]
    assert sorted(res["bucket_times"]) == [10, 20, 30]
    mods = res["module"].buckets
    ptr = {k: m._exec_group.execs[0].arg_dict["lstm_parameters"]
           ._read().data_ptr() for k, m in mods.items()}
    assert len(set(ptr.values())) == 1


def test_bucketing_lstm_twin_defaults_are_the_jax_script():
    """The JAX script's data and widths: 800 uniform sentences over 50
    tokens, buckets 10/20/30, batch 16, one layer of 128."""
    args = ["--cpu", "--num-epochs", "1"]
    res = bucketing_lstm.main(args)
    assert res["buckets_bound"] == [10, 20, 30]
    assert res["batch_size"] == 16
    mod = res["module"].buckets[30]
    params = mod.get_params()[0]
    assert params["embed_weight"].shape == (50, 32)
    assert params["lstm_parameters"].shape == (
        rnn_op.rnn_param_size(1, 32, 128, False, "lstm"),)
