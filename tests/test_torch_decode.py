"""The port's decode engine (``mxnet_tpu_torch.serving.decode``) against
the JAX package's (``mxnet_tpu.serving.decode``) on the CPU, float32,
with the same numpy inputs, and its own contracts, mirroring
``tests/test_serving_decode.py``.

Against JAX (rtol 1e-5, atol 1e-6 of the reference's scale):
``LSTMCharLM`` and
``TransformerLM`` step and prefill (1 and 2 layers; the transformer's
window slide); ``init_params`` and ``params_digest`` and the sampler's
counter-hash uniforms bit for bit; greedy and sampled streams against the
JAX ``DecodeEngine`` under the tie rule: XLA and torch may round
sigmoid/tanh/exp an ulp apart, so a token may differ only where the JAX
scores' top two lie within 1e-5 of each other, and the streams are not
compared past that point.

Within the port, bit for bit: continuous streams equal unbatched ones,
bucketed prefill equals the exact-length forward, padding rows never
land. The bf16 and int8_weight modes have a test here (and against the
JAX engine in ``test_torch_quant.py``). Refusals (executable cache), the
thread-local
grad mode of the scheduler, the supervised restart (a launch patched to
raise once: the port has no ``faults/`` seams yet) and state never
written in place have a test each.
"""
import threading
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.serving import decode as jdec
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serving import decode as tdec
from mxnet_tpu_torch.serving.decode import (DecodeEngine, LSTMCharLM,
                                            TransformerLM, PREFILL_ROWS)
from mxnet_tpu_torch.serving.errors import (RequestAbandoned, ServerClosed,
                                            TenantShed)

torch.set_num_threads(2)

VOCAB = 17
RTOL, ATOL = 1e-5, 1e-6
TIE = 1e-5
CPU = mx.cpu()


@pytest.fixture(scope="module")
def model():
    return LSTMCharLM(vocab_size=VOCAB, num_hidden=16, num_embed=8)


@pytest.fixture(scope="module")
def params(model):
    return model.init_params(seed=3)


def _prompts(n, seed=0, lo=2, hi=12, vocab=VOCAB):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(0, vocab, size=rng.randint(lo, hi)))
            for _ in range(n)]


def _engine(model, params, **kw):
    kw.setdefault("slots", 4)
    kw.setdefault("max_prefill_len", 8)
    kw.setdefault("context", CPU)
    return DecodeEngine(model, params, **kw)


def _sequential_streams(model, params, prompts, max_new=10, **kw):
    """Each request decoded alone through a fresh engine."""
    eng = _engine(model, params, **kw)
    eng.warmup()
    out = [eng.generate(p, max_new_tokens=max_new, seed=i, timeout=60)
           for i, p in enumerate(prompts)]
    eng.shutdown(drain=True)
    eng.release()
    return out


def _twins(kind):
    """(port model, JAX model) of one configuration."""
    if kind == "lstm1":
        args, cls = (VOCAB, 16, 8, 1), "LSTMCharLM"
    elif kind == "lstm2":
        args, cls = (VOCAB, 16, 8, 2), "LSTMCharLM"
    else:
        args, cls = (VOCAB, 16, 2, 8, 2), "TransformerLM"
    return getattr(tdec, cls)(*args), getattr(jdec, cls)(*args)


def _t(params):
    return {k: torch.from_numpy(np.array(v)) for k, v in params.items()}


def _j(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


def _close(got, want):
    """rtol 1e-5; atol 1e-6 of the larger of 1 and the reference's
    max-abs: logits of a 2-block transformer reach |24| here and cancel
    to values near 0, where one float32 rounding of the sum is ~2e-6."""
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=RTOL,
        atol=ATOL * max(1.0, float(np.abs(want).max(initial=0.0))))


def _random_state(kind, B, rng, model):
    """The same state rows for both packages (numpy)."""
    if kind.startswith("lstm"):
        shape = (B, model.num_layers, model.num_hidden)
        return {"h": rng.randn(*shape).astype(np.float32) * 0.5,
                "c": rng.randn(*shape).astype(np.float32) * 0.5}
    T = model.window
    ln = np.array([0, 3, T - 1, T, T][:B], np.int32)
    ctx = rng.randint(0, VOCAB, size=(B, T)).astype(np.int32)
    ctx[np.arange(T)[None, :] >= ln[:, None]] = 0
    return {"ctx": ctx, "len": ln}


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["lstm1", "lstm2", "transformer"])
def test_init_params_and_digest_bit_for_bit(kind):
    tm, jm = _twins(kind)
    for seed in (0, 7):
        tp, jp = tm.init_params(seed=seed), jm.init_params(seed=seed)
        assert sorted(tp) == sorted(jp)
        for k in tp:
            assert tp[k].dtype == jp[k].dtype and np.array_equal(tp[k],
                                                                 jp[k]), k
        assert tm.params_digest(tp) == jm.params_digest(jp)
    assert tm.signature() == jm.signature()


@pytest.mark.parametrize("kind", ["lstm1", "lstm2", "transformer"])
def test_step_matches_jax(kind):
    tm, jm = _twins(kind)
    p = jm.init_params(seed=1, scale=0.5)
    rng = np.random.RandomState(2)
    B = 5
    state = _random_state(kind, B, rng, jm)
    tokens = rng.randint(0, VOCAB, size=B)
    js, jl = jm.step(_j(p), jnp.asarray(tokens, jnp.int32),
                     {k: jnp.asarray(v) for k, v in state.items()})
    ts, tl = tm.step(_t(p), torch.from_numpy(tokens.astype(np.int64)),
                     {k: torch.from_numpy(v) for k, v in state.items()})
    _close(tl, jl)
    for k in js:
        if np.asarray(js[k]).dtype.kind == "i":
            assert np.array_equal(ts[k].numpy(), np.asarray(js[k])), k
        else:
            _close(ts[k], js[k])


@pytest.mark.parametrize("kind", ["lstm1", "lstm2", "transformer"])
def test_prefill_matches_jax(kind):
    """Rows of different lengths (one of them padding), from a random
    state; for the transformer, prompts longer than the window slide it
    (window 8, length 20)."""
    tm, jm = _twins(kind)
    p = jm.init_params(seed=4, scale=0.5)
    rng = np.random.RandomState(5)
    L = 20 if kind == "transformer" else 9
    tokens = rng.randint(0, VOCAB, size=(3, L))
    lengths = np.array([L, L // 2 + 1, 0])
    if kind == "transformer":
        state = {"ctx": np.zeros((3, jm.window), np.int32),
                 "len": np.zeros((3,), np.int32)}
    else:
        state = _random_state(kind, 3, rng, jm)
    js, jl = jm.prefill(_j(p), jnp.asarray(tokens, jnp.int32),
                        jnp.asarray(lengths, jnp.int32),
                        {k: jnp.asarray(v) for k, v in state.items()})
    ts, tl = tm.prefill(_t(p), torch.from_numpy(tokens),
                        torch.from_numpy(lengths),
                        {k: torch.from_numpy(v) for k, v in state.items()})
    _close(tl, jl)
    for k in js:
        if np.asarray(js[k]).dtype.kind == "i":
            assert np.array_equal(ts[k].numpy(), np.asarray(js[k])), k
        else:
            _close(ts[k], js[k])
    if kind == "transformer":
        assert int(ts["len"][0]) == jm.window     # the window slid


def _jax_uniforms(seeds, steps, vocab):
    """The JAX package's counter hash, as ``DecodeEngine._select`` writes
    it (uint32 jnp arithmetic)."""
    ctr = (jnp.asarray(seeds, jnp.uint32)[:, None]
           ^ (jnp.asarray(steps, jnp.uint32)[:, None]
              * jnp.uint32(0x9E3779B9)))
    ctr = ctr + jnp.arange(vocab, dtype=jnp.uint32)[None, :] \
        * jnp.uint32(0x85EBCA77)
    x = ctr
    for mult in (0x7FEB352D, 0x846CA68B):
        x = x ^ (x >> jnp.uint32(16))
        x = x * jnp.uint32(mult)
    x = x ^ (x >> jnp.uint32(16))
    u = (x >> jnp.uint32(8)).astype(jnp.float32) \
        * np.float32(1.0 / (1 << 24))
    return np.asarray(jnp.clip(u, 1e-7, 1.0 - 1e-7))


def test_counter_hash_uniforms_bit_for_bit():
    """10^5 (seed, step, token) counters, seeds over the whole uint32
    range: the port's int64 arithmetic equals JAX's uint32 bit for bit;
    then the JAX ``_select`` itself and the port's pick the same tokens
    from the same logits."""
    rng = np.random.RandomState(0)
    B, V = 100, 1000
    seeds = rng.randint(0, 2 ** 32, size=B, dtype=np.uint64)
    seeds[:3] = [0, 1, 2 ** 32 - 1]
    steps = rng.randint(0, 2 ** 31 - 1, size=B)
    got = tdec.counter_uniform(torch.from_numpy(seeds.astype(np.int64)),
                               torch.from_numpy(steps.astype(np.int64)), V)
    assert np.array_equal(got.numpy(), _jax_uniforms(seeds, steps, V))

    logits = rng.randn(B, V).astype(np.float32)
    jsel = jdec.DecodeEngine._select(types.SimpleNamespace(
        _temperature=0.7), jnp.asarray(logits),
        jnp.asarray(steps, jnp.int32), jnp.asarray(seeds.astype(np.uint32)))
    teng = _engine(LSTMCharLM(V, 8, 4), LSTMCharLM(V, 8, 4).init_params(0),
                   temperature=0.7, start=False)
    tsel = teng._select(torch.from_numpy(logits),
                        torch.from_numpy(steps.astype(np.int64)),
                        torch.from_numpy(seeds.astype(np.int64)))
    teng.release()
    assert np.array_equal(tsel.numpy(), np.asarray(jsel))


def _teacher_scores(jm, p, prompt, stream, temperature, seed):
    """JAX scores before each token of ``stream``, teacher-forced on
    ``stream`` one step at a time (the sampler's Gumbel noise added when
    temperature > 0)."""
    params = _j(p)
    state = {k: jnp.zeros((1,) + s, dt)
             for k, (s, dt) in jm.state_struct().items()}
    logits = None
    for tok in prompt:
        state, logits = jm.step(params, jnp.asarray([tok], jnp.int32),
                                state)
    out = []
    for i, tok in enumerate(stream):
        lg = np.asarray(logits)[0].astype(np.float32)
        if temperature > 0:
            u = _jax_uniforms(np.array([seed], np.uint64), np.array([i]),
                              lg.size)[0]
            lg = lg / np.float32(temperature) - np.log(-np.log(u))
        out.append(lg)
        state, logits = jm.step(params, jnp.asarray([tok], jnp.int32),
                                state)
    return out


def _assert_tie_rule(got, want, scores):
    """Streams equal up to the first difference, which must sit on a
    tie of the JAX scores (top two within TIE)."""
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            top = np.sort(scores[i])[-2:]
            assert top[1] - top[0] <= TIE, \
                "token %d differs off a tie: %s vs %s (gap %g)" % (
                    i, got, want, top[1] - top[0])
            return
    assert len(got) == len(want)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_streams_match_jax_engine(temperature):
    tm, jm = _twins("lstm1")
    p = jm.init_params(seed=3, scale=0.6)
    prompts = _prompts(6, seed=1)
    jeng = jdec.DecodeEngine(jm, p, slots=4, max_prefill_len=8,
                             temperature=temperature, start=False)
    jeng.warmup()
    jreqs = [jeng.submit(q, max_new_tokens=10, seed=i)
             for i, q in enumerate(prompts)]
    jeng.start()
    want = [r.result(timeout=120) for r in jreqs]
    jeng.shutdown(drain=True)
    jeng.release()
    teng = _engine(tm, p, temperature=temperature, start=False)
    teng.warmup()
    treqs = [teng.submit(q, max_new_tokens=10, seed=i)
             for i, q in enumerate(prompts)]
    teng.start()
    got = [r.result(timeout=60) for r in treqs]
    teng.shutdown(drain=True)
    teng.release()
    assert len(set(map(tuple, want))) > 1    # the streams say something
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_tie_rule(g, w, _teacher_scores(jm, p, prompts[i], w,
                                               temperature, i))


def test_transformer_streams_match_jax_engine():
    """The transformer through both engines, prompts past the window
    (8) and the top bucket (8), so the window slides while decoding."""
    tm, jm = _twins("transformer")
    p = jm.init_params(seed=0, scale=0.5)
    prompts = _prompts(3, seed=3, lo=3, hi=14)
    jeng = jdec.DecodeEngine(jm, p, slots=2, max_prefill_len=8)
    jeng.warmup()
    want = [jeng.generate(q, max_new_tokens=6, seed=i, timeout=120)
            for i, q in enumerate(prompts)]
    jeng.shutdown(drain=True)
    jeng.release()
    teng = _engine(tm, p, slots=2)
    teng.warmup()
    got = [teng.generate(q, max_new_tokens=6, seed=i, timeout=60)
           for i, q in enumerate(prompts)]
    teng.shutdown(drain=True)
    teng.release()
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_tie_rule(g, w, _teacher_scores(jm, p, prompts[i], w,
                                               0.0, i))


# ---------------------------------------------------------------------------
# the port's own contracts (tests/test_serving_decode.py)
# ---------------------------------------------------------------------------
def test_continuous_streams_bitwise_equal_unbatched(model, params):
    prompts = _prompts(9, seed=1)
    eng = _engine(model, params, start=False)
    eng.warmup()
    reqs = [eng.submit(p, max_new_tokens=10, seed=i)
            for i, p in enumerate(prompts)]
    eng.start()
    streams = [r.result(timeout=60) for r in reqs]
    eng.shutdown(drain=True)
    assert eng.stats()["decode"]["avg_occupancy"] > 0.5  # batching real
    assert streams == _sequential_streams(model, params, prompts)
    eng.release()


def test_transformer_continuous_streams_bitwise_equal_unbatched():
    tm = TransformerLM(VOCAB, 16, 2, 8, 2)
    p = tm.init_params(seed=2, scale=0.5)
    prompts = _prompts(5, seed=4, lo=2, hi=12)
    eng = _engine(tm, p, slots=3, start=False)
    eng.warmup()
    reqs = [eng.submit(q, max_new_tokens=9, seed=i)
            for i, q in enumerate(prompts)]
    eng.start()
    streams = [r.result(timeout=60) for r in reqs]
    eng.shutdown(drain=True)
    eng.release()
    assert streams == _sequential_streams(tm, p, prompts, max_new=9,
                                          slots=3)


def test_sampled_streams_bitwise_and_seed_dependent(model, params):
    prompts = _prompts(6, seed=2)
    eng = _engine(model, params, temperature=0.7, start=False)
    eng.warmup()
    reqs = [eng.submit(p, max_new_tokens=8, seed=100 + i)
            for i, p in enumerate(prompts)]
    eng.start()
    streams = [r.result(timeout=60) for r in reqs]
    eng.shutdown(drain=True)
    eng.release()
    eng2 = _engine(model, params, temperature=0.7)
    eng2.warmup()
    for i, p in enumerate(prompts):
        assert eng2.generate(p, max_new_tokens=8, seed=100 + i,
                             timeout=60) == streams[i]
    a = eng2.generate(prompts[0], max_new_tokens=8, seed=1, timeout=60)
    b = eng2.generate(prompts[0], max_new_tokens=8, seed=2, timeout=60)
    eng2.shutdown(drain=True)
    eng2.release()
    assert a != b, "different seeds should explore different streams"


@pytest.mark.parametrize("kind", ["lstm", "transformer"])
def test_prefill_bucket_parity(model, params, kind):
    """Padded + masked prefill equals the exact-length forward bit for
    bit, the chunked path (past max_prefill_len) included."""
    if kind == "transformer":
        model = TransformerLM(VOCAB, 16, 2, 8, 2)
        params = model.init_params(seed=1)
    eng = _engine(model, params, start=False)
    eng.warmup()
    rng = np.random.RandomState(7)
    for L in (1, 3, 4, 5, 8, 11, 19):
        assert eng.prefill_parity(list(rng.randint(0, VOCAB, size=L))), L
    eng.shutdown()
    eng.release()


def test_eos_retires_early(model, params):
    eng = _engine(model, params, eos_id=0)
    eng.warmup()
    stream = eng.generate([1, 2, 3], max_new_tokens=64, seed=0, timeout=60)
    eng.shutdown(drain=True)
    eng.release()
    if 0 in stream:
        assert stream.index(0) == len(stream) - 1, "eos must end the stream"
    else:
        assert len(stream) == 64


def test_transcript_pure_function_of_arrivals(model, params):
    prompts = _prompts(8, seed=4)

    def run():
        eng = _engine(model, params, start=False)
        eng.warmup()
        reqs = [eng.submit(p, max_new_tokens=5 + (i % 4), seed=i)
                for i, p in enumerate(prompts)]
        eng.start()
        for r in reqs:
            r.result(timeout=60)
        eng.shutdown(drain=True)
        t = eng.transcript()
        eng.release()
        return t

    t1, t2 = run(), run()
    assert t1 == t2
    admits = [e for e in t1 if e[0] == "admit"]
    retires = [e for e in t1 if e[0] == "retire"]
    assert len(admits) == len(prompts) and len(retires) == len(prompts)
    assert all(e[4] == "ok" for e in retires)


def test_occupancy_churn_leaves_compiles_frozen(model, params):
    eng = _engine(model, params, start=False)
    report = eng.warmup()
    assert set(report) == {"state_init", "step", "prefill_4", "prefill_8"}
    assert all(r["source"] == "eager" for r in report.values())
    compiles0 = eng.stats()["compiles"]
    assert compiles0 == 4
    reqs = [eng.submit(p, max_new_tokens=2 + (i * 3) % 9, seed=i)
            for i, p in enumerate(_prompts(12, seed=5, lo=1, hi=20))]
    eng.start()
    for r in reqs:
        r.result(timeout=60)
    eng.shutdown(drain=True)
    assert eng.stats()["compiles"] == compiles0
    assert eng.stats()["decode"]["steps"] > 0
    eng.release()


def test_shutdown_drains_without_hanging_futures(model, params):
    eng = _engine(model, params, start=False)
    eng.warmup()
    reqs = [eng.submit(p, max_new_tokens=12, seed=i)
            for i, p in enumerate(_prompts(10, seed=6))]
    eng.start()
    eng.shutdown(drain=True, timeout=120)
    for r in reqs:
        assert r.done()
        assert len(r.result(timeout=1)) == 12
    eng.release()


def test_shutdown_no_drain_resolves_everything(model, params):
    eng = _engine(model, params, start=False)
    eng.warmup()
    reqs = [eng.submit(p, max_new_tokens=1000, seed=i)
            for i, p in enumerate(_prompts(10, seed=7))]
    eng.start()
    t0 = time.time()
    while not any(r.tokens() for r in reqs) and time.time() - t0 < 60:
        time.sleep(0.002)
    eng.shutdown(drain=False, timeout=60)
    for r in reqs:
        assert r.done(), "no-drain shutdown left a future hanging"
        with pytest.raises((ServerClosed, RequestAbandoned)):
            r.result(timeout=1)
    with pytest.raises(ServerClosed):
        eng.submit([1], max_new_tokens=1)
    eng.release()


def test_client_cancel_mid_stream(model, params):
    eng = _engine(model, params)
    eng.warmup()
    req = eng.submit([1, 2, 3], max_new_tokens=200, seed=0)
    t0 = time.time()
    while len(req.tokens()) < 3 and time.time() - t0 < 60:
        time.sleep(0.001)
    req.cancel()
    with pytest.raises(RequestAbandoned):
        req.result(timeout=30)
    assert len(req.tokens()) >= 3  # the partial stream stays readable
    eng.shutdown(drain=True)
    assert eng.stats()["decode"]["abandoned"] == 1
    eng.release()


def test_worker_crash_restarts_and_serves(model, params):
    """A launch that raises once (the third step) restarts the
    scheduler; the slot state survives and every stream still equals
    the sequential reference bit for bit."""
    prompts = _prompts(6, seed=9)
    ref = _sequential_streams(model, params, prompts, max_new=8)
    eng = _engine(model, params, start=False)
    eng.warmup()
    launch, calls = eng._launch_step, []

    def flaky(*args, **kwargs):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("injected scheduler crash")
        return launch(*args, **kwargs)

    eng._launch_step = flaky
    reqs = [eng.submit(p, max_new_tokens=8, seed=i)
            for i, p in enumerate(prompts)]
    eng.start()
    streams = [r.result(timeout=60) for r in reqs]
    eng.shutdown(drain=True)
    st = eng.stats()
    eng.release()
    assert st["worker_restarts"] == 1
    assert streams == ref, "streams diverged across a worker restart"


def test_ttft_breach_sheds_admission(model, params):
    eng = _engine(model, params, ttft_slo_ms=1.0, shed_on_breach=True,
                  start=False)
    now = time.time()
    for i in range(400):
        eng.slo_ttft.record(50.0, "ok", ts=now - 0.5 + i * 0.001)
    assert eng.slo_ttft.breached_cached()
    with pytest.raises(TenantShed):
        eng.submit([1, 2], max_new_tokens=2)
    assert eng.stats()["sheds"] == 1
    eng.shutdown(drain=False)
    eng.release()


def test_slo_gauges_and_traces_populated(model, params):
    was_enabled = telemetry.enabled()
    telemetry.enable()
    try:
        eng = _engine(model, params)
        eng.warmup()
        for i, p in enumerate(_prompts(4, seed=13)):
            eng.generate(p, max_new_tokens=6, seed=i, timeout=60)
        eng.shutdown(drain=True)
        gauges = telemetry.registry().snapshot()["gauges"]
        for frag in ("decode.ttft", "decode.per_token"):
            assert any(k.startswith("slo.%s." % frag) for k in gauges), frag
        traces = eng.request_traces()
        assert len(traces) == 4
        for t in traces:
            assert set(t["phases"]) == {"queue_wait_ms", "prefill_ms",
                                        "decode_ms", "resolve_ms"}
            assert t["phases"]["prefill_ms"] >= 0.0
            assert t["outcome"] == "ok"
        st = eng.stats()
        assert st["decode"]["ttft_ms"]["count"] == 4
        assert st["decode"]["tokens"] == 4 * 6
        eng.release()
    finally:
        if not was_enabled:
            telemetry.disable()


@pytest.mark.parametrize("kind", ["lstm", "transformer"])
def test_from_params_adopts(kind):
    if kind == "lstm":
        src = LSTMCharLM(vocab_size=11, num_hidden=8, num_embed=4,
                         num_layers=2)
        params = src.init_params(seed=1)
        adopted = LSTMCharLM.from_params(
            {k: mx.nd.array(v, ctx=CPU) for k, v in params.items()})
        assert (adopted.vocab_size, adopted.num_hidden, adopted.num_embed,
                adopted.num_layers) == (11, 8, 4, 2)
    else:
        src = TransformerLM(11, 8, 2, 6, 2)
        params = src.init_params(seed=1)
        adopted = TransformerLM.from_params(params, num_heads=2)
        assert adopted.signature() == src.signature()
    assert adopted.params_digest(params) == src.params_digest(params)
    eng = DecodeEngine(adopted, None, slots=2, max_prefill_len=4,
                       context=CPU)
    assert eng.params_digest == src.params_digest(params)
    eng.warmup()
    assert len(eng.generate([1, 2, 3], max_new_tokens=4, timeout=60)) == 4
    eng.shutdown(drain=True)
    eng.release()
    bad = dict(params)
    bad.pop("embed_weight" if kind == "transformer" else "pred_bias")
    with pytest.raises((MXNetError, KeyError)):
        (LSTMCharLM.from_params(bad) if kind == "lstm"
         else TransformerLM.from_params(bad, num_heads=2))


def test_prefill_rows_padding_never_lands(model, params):
    """The padding row of PREFILL_ROWS targets index == slots and must
    never reach slots 0..n-1: admitting A then B leaves A's stream
    untouched."""
    assert PREFILL_ROWS >= 2
    eng = _engine(model, params, slots=2, start=False)
    eng.warmup()
    ra = eng.submit([1, 2, 3, 4], max_new_tokens=10, seed=0)
    rb = eng.submit([5, 6], max_new_tokens=10, seed=1)
    eng.start()
    a, b = ra.result(timeout=60), rb.result(timeout=60)
    eng.shutdown(drain=True)
    eng.release()
    assert [a, b] == _sequential_streams(model, params, [[1, 2, 3, 4],
                                                         [5, 6]],
                                         max_new=10, slots=2)


def test_prefill_padding_rows_leave_state_untouched(model, params):
    """A prefill whose rows are all padding returns the state's values;
    one real row changes exactly its slot."""
    eng = _engine(model, params, slots=3, start=False)
    rng = np.random.RandomState(0)
    state = {k: torch.from_numpy(rng.randn(3, 1, 16).astype(np.float32))
             for k in ("h", "c")}
    before = {k: v.clone() for k, v in state.items()}
    toks = np.zeros((PREFILL_ROWS, 4), np.int64)
    toks[0] = [1, 2, 3, 4]
    zero = np.zeros((PREFILL_ROWS,), np.int64)
    with torch.no_grad():
        pad, _, _ = eng._launch_prefill(4, state, toks, zero + [4, 0],
                                        np.full((PREFILL_ROWS,), 3), zero,
                                        zero)
        one, _, _ = eng._launch_prefill(4, state, toks, zero + [4, 0],
                                        np.array([1, 3]), zero, zero)
    for k in state:
        assert torch.equal(state[k], before[k])     # never written
        assert torch.equal(pad[k], before[k])
        assert torch.equal(one[k][[0, 2]], before[k][[0, 2]])
        assert not torch.equal(one[k][1], before[k][1])
    eng.release()


def test_transformer_step_never_writes_state(model):
    tm = TransformerLM(VOCAB, 16, 2, 8, 1)
    eng = _engine(tm, tm.init_params(seed=0), slots=3, start=False)
    state = {"ctx": torch.tensor([[1] * 8, [2, 3, 0, 0, 0, 0, 0, 0],
                                  [0] * 8], dtype=torch.int32),
             "len": torch.tensor([8, 2, 0], dtype=torch.int32)}
    before = {k: v.clone() for k, v in state.items()}
    tok = torch.tensor([5, 6, 7])
    with torch.no_grad():
        new, _ = eng.step_device(state, tok, torch.tensor([True, True,
                                                           False]),
                                 torch.ones(3, dtype=torch.int64),
                                 torch.zeros(3, dtype=torch.int64))
    for k in state:
        assert torch.equal(state[k], before[k])
    assert new["ctx"][0].tolist() == [1] * 7 + [5]        # slid
    assert new["ctx"][1].tolist() == [2, 3, 6, 0, 0, 0, 0, 0]
    assert new["len"].tolist() == [8, 3, 0]               # row 2 inactive
    assert torch.equal(new["ctx"][2], before["ctx"][2])
    eng.release()


def test_scheduler_thread_records_no_autograd(model, params):
    """no_grad and the current device are per thread in torch: the
    scheduler enters them itself. With parameters that require grad,
    200 steps leave no state tensor requiring grad and no output with a
    grad_fn."""
    eng = _engine(model, params, slots=2, start=False)
    for t in eng._params.values():
        t.requires_grad_(True)
    seen = []
    launch = eng._launch_step

    def spy(*args, **kwargs):
        state, nxt = launch(*args, **kwargs)
        seen.append((threading.current_thread().name,
                     any(v.requires_grad or v.grad_fn is not None
                         for v in state.values()),
                     nxt.grad_fn is not None))
        return state, nxt

    eng._launch_step = spy
    reqs = [eng.submit([1, 2, 3], max_new_tokens=200, seed=i)
            for i in range(2)]
    eng.start()
    for r in reqs:
        assert len(r.result(timeout=120)) == 200
    eng.shutdown(drain=True)
    assert len(seen) >= 199
    assert all(name == "mxtorch-decode" for name, _, _ in seen)
    assert not any(g for _, g, _ in seen)
    assert not any(g for _, _, g in seen)
    assert not any(v.requires_grad for v in eng._state.values())
    eng.release()


def test_step_argument_and_weight_bytes(model, params):
    eng = _engine(model, params, start=False)
    w = sum(v.size * 4 for v in params.values())
    assert eng.weight_bytes() == w
    state = 2 * 4 * model.num_layers * model.num_hidden * 4
    assert eng.step_argument_bytes() == w + state + 4 * 4 * 8
    eng.release()


# ---------------------------------------------------------------------------
# the executable cache (refused before it was ported; now the working path)
# ---------------------------------------------------------------------------
def _cached_streams(model, params, cache_dir, prompts, **kw):
    eng = _engine(model, params, **kw)
    rep = eng.warmup(cache_dir=cache_dir)
    reqs = [eng.submit(p, max_new_tokens=8, seed=i)
            for i, p in enumerate(prompts)]
    streams = [r.result(timeout=60) for r in reqs]
    compiles = eng.stats()["compiles"]
    eng.shutdown()
    eng.release()
    return rep, streams, compiles


def test_warmup_cache_dir_refused(model, params, tmp_path):
    """``warmup(cache_dir=)``: a cold engine traces every program
    (state init, step, each prefill bucket) and commits it; a warm one
    loads all of them, traces nothing, compiles nothing, and streams
    bit for bit as the cold one and the eager engine."""
    from mxnet_tpu_torch.serving import cache as C
    prompts = _prompts(3, seed=5, hi=14)
    eager = _sequential_streams(model, params, prompts, max_new=8)
    cold, s_cold, c_cold = _cached_streams(model, params, str(tmp_path),
                                           prompts)
    names = {"state_init", "step", "prefill_4", "prefill_8"}
    assert set(cold) == names
    assert {r["source"] for r in cold.values()} == {"compiled"}
    assert c_cold == len(names)
    t0 = C.traces
    warm, s_warm, c_warm = _cached_streams(model, params, str(tmp_path),
                                           prompts)
    assert C.traces == t0 and c_warm == 0
    assert {r["source"] for r in warm.values()} == {"deserialized"}
    assert s_cold == s_warm == eager


def test_compile_cache_env_refused(model, params, tmp_path, monkeypatch):
    """``MXNET_COMPILE_CACHE_DIR`` is the default store (``<dir>/aot``),
    and the key keeps the sampler's temperature: a sampled engine never
    loads the greedy engine's step."""
    monkeypatch.setenv("MXNET_COMPILE_CACHE_DIR", str(tmp_path))
    prompts = _prompts(2, seed=6)
    rep, s0, _ = _cached_streams(model, params, None, prompts)
    assert {r["source"] for r in rep.values()} == {"compiled"}
    assert (tmp_path / "aot").is_dir()
    rep, s1, _ = _cached_streams(model, params, None, prompts,
                                 temperature=0.8)
    assert {r["source"] for r in rep.values()} == {"compiled"}
    rep, s2, _ = _cached_streams(model, params, None, prompts,
                                 temperature=0.8)
    assert {r["source"] for r in rep.values()} == {"deserialized"}
    assert s1 == s2 and s1 != s0


@pytest.mark.parametrize("precision", ["int8_weight", "bf16"])
def test_precision_modes_decode(model, params, precision):
    """The two narrow decode modes: the staged weights (int8 leaves with
    float32 scales, or bfloat16) shrink the bytes a step receives below
    the f32 engine's, the mode is reported, the bucketed prefill equals
    the exact-length forward bit for bit, and a stream repeats; its
    greedy tokens follow the f32 engine's on most prompts."""
    e32 = _engine(model, params, precision="f32", start=False)
    eng = _engine(model, params, precision=precision, start=False)
    try:
        d = eng.stats()["decode"]
        assert d["precision_mode"] == precision
        assert d["weight_quant"] == \
            ("int8" if precision == "int8_weight" else None)
        assert e32.stats()["decode"]["precision_mode"] == "f32"
        if precision == "int8_weight":
            assert all(v.q.dtype == torch.int8 and v.s.dtype == torch.float32
                       for k, v in eng._params.items() if k.endswith("weight"))
        else:
            assert all(v.dtype == torch.bfloat16
                       for v in eng._params.values())
        assert eng.weight_bytes() < e32.weight_bytes()
        assert eng.step_argument_bytes() < e32.step_argument_bytes()
        for n in (1, 3, 7, 8, 11):
            assert eng.prefill_parity(list(range(1, n + 1)))
        eng.start()
        e32.start()
        prompts = _prompts(8, seed=2)
        s1 = [eng.generate(p, max_new_tokens=1, timeout=60) for p in prompts]
        s2 = [eng.generate(p, max_new_tokens=1, timeout=60) for p in prompts]
        ref = [e32.generate(p, max_new_tokens=1, timeout=60)
               for p in prompts]
        assert s1 == s2
        assert sum(a == b for a, b in zip(s1, ref)) >= 6
    finally:
        for e in (eng, e32):
            e.shutdown(drain=True)
            e.release()


def test_default_context_is_the_card(model, params):
    """Without ``context=`` the engine runs on gpu(0); with no card it
    raises, and never falls back to the CPU."""
    if torch.cuda.is_available():
        eng = DecodeEngine(model, params, start=False)
        assert eng.device.type == "cuda"
        eng.release()
    else:
        with pytest.raises(MXNetError, match="CUDA"):
            DecodeEngine(model, params, start=False)
    with pytest.raises(MXNetError, match="Context"):
        DecodeEngine(model, params, start=False, context=[CPU, CPU])
