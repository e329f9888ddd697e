"""BatchNorm(+ReLU) core of the PyTorch port vs the JAX package, on the CPU.

The port's ``kernels/batchnorm.py`` plain versions (what its wrappers run
for CPU tensors) and its autograd core (``ops/nn.py bn_train_core``) are
held against the JAX hand-VJP core ``_bn_train_core`` (through
``jax.vjp``) and against ``bn_bwd_jnp``, the plain reference of the TPU
kernel ``bn_bwd_onepass`` (``tools/bn_pallas_probe.py``). Inputs are made
with numpy from a seed and handed to both. Tolerance (float32):
rtol=1e-5, atol=1e-6 — the two frameworks sum in different orders, which
moves the last few bits of a per-channel sum of a few hundred terms.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops.nn import _bn_train_core
from tools.bn_pallas_probe import bn_bwd_jnp

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kernels import batchnorm as K
from mxnet_tpu_torch.ops.nn import bn_train_core

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
EPS = 2e-5
SHAPES = [(4, 8, 5, 7), (2, 3, 6, 6)]


def _inputs(shape, seed):
    rs = np.random.RandomState(seed)
    C = shape[1]
    x = (rs.randn(*shape) * 2.0 + 0.5).astype(np.float32)
    gamma = (rs.rand(C) + 0.5).astype(np.float32)
    beta = (rs.randn(C) * 0.1).astype(np.float32)
    c = (rs.randn(C) * 0.1).astype(np.float32)
    dout = rs.randn(*shape).astype(np.float32)
    return x, gamma, beta, c, dout


def _close(a, b, what):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32),
                               rtol=RTOL, atol=ATOL, err_msg=what)


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("fix_gamma", [False, True])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_core_matches_jax_vjp(shape, relu, fix_gamma, exact, monkeypatch):
    monkeypatch.setenv("MXNET_BN_EXACT_STATS", "1" if exact else "0")
    x, gamma, beta, c, dout = _inputs(shape, seed=sum(shape))

    def jcore(xx, g, b):
        return _bn_train_core(xx, g, b, jnp.asarray(c), EPS, fix_gamma, relu)

    (jy, jmean, jvar), vjp = jax.vjp(jcore, jnp.asarray(x), jnp.asarray(gamma),
                                     jnp.asarray(beta))
    C = shape[1]
    jdx, jdg, jdb = vjp((jnp.asarray(dout), jnp.zeros(C), jnp.zeros(C)))

    tx = torch.tensor(x, requires_grad=True)
    tg = torch.tensor(gamma, requires_grad=True)
    tb = torch.tensor(beta, requires_grad=True)
    ty, tmean, tvar = bn_train_core(tx, tg, tb, torch.tensor(c), EPS,
                                    fix_gamma, relu)
    ty.backward(torch.tensor(dout))

    _close(ty.detach(), jy, "y")
    _close(tmean, jmean, "mean")
    _close(tvar, jvar, "var")
    _close(tx.grad, jdx, "dx")
    _close(tb.grad, jdb, "dbeta")
    _close(tg.grad, jdg, "dgamma")
    if fix_gamma:
        assert not tg.grad.abs().any()
    assert not tmean.requires_grad and not tvar.requires_grad


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_plain_matches_probe_reference(shape, relu):
    """bn_bwd's plain version vs K1's own plain reference, from the same
    forward statistics and affine."""
    x, gamma, beta, c, dout = _inputs(shape, seed=7 + shape[1])
    y, mean, var, rstd, scale, shift = K.bn_fwd_plain(
        torch.tensor(x), torch.tensor(gamma), torch.tensor(beta),
        torch.tensor(c), EPS, False, relu, False)
    dx, dbeta, dgamma = K.bn_bwd_plain(torch.tensor(dout), torch.tensor(x),
                                       rstd, mean, scale, shift, relu)
    jdx, jdb, jdg = bn_bwd_jnp(jnp.asarray(dout), jnp.asarray(x),
                               jnp.asarray(rstd.numpy()),
                               jnp.asarray(mean.numpy()),
                               jnp.asarray(scale.numpy()),
                               jnp.asarray(shift.numpy()), relu)
    _close(dx, jdx, "dx")
    _close(dbeta, jdb, "dbeta")
    _close(dgamma, jdg, "dgamma")


def test_wrappers_take_plain_version_only_on_cpu():
    x, gamma, beta, c, dout = _inputs((2, 3, 4, 4), seed=3)
    args = [torch.tensor(v) for v in (x, gamma, beta, c)]
    before = (K.bn_fwd.launches, K.bn_bwd.launches)
    out = K.bn_fwd(*args, EPS, False, True, False)
    ref = K.bn_fwd_plain(*args, EPS, False, True, False)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    dx = K.bn_bwd(torch.tensor(dout), args[0], out[3], out[1], out[4],
                  out[5], True)
    dref = K.bn_bwd_plain(torch.tensor(dout), args[0], out[3], out[1],
                          out[4], out[5], True)
    for a, b in zip(dx, dref):
        assert torch.equal(a, b)
    # plain runs are not kernel launches
    assert (K.bn_fwd.launches, K.bn_bwd.launches) == before
    meta = [torch.empty(t.shape, device="meta") for t in args]
    with pytest.raises(MXNetError):
        K.bn_fwd(*meta, EPS, False, True, False)


def test_bf16_forward_tracks_f32():
    """bfloat16 activations: statistics in float32, output within one
    bfloat16 rounding of the float32 result."""
    x, gamma, beta, c, _ = _inputs((4, 8, 5, 7), seed=11)
    args = [torch.tensor(v) for v in (gamma, beta, c)]
    xb = torch.tensor(x).to(torch.bfloat16)
    yb, mb, vb = K.bn_fwd(xb, *args, EPS, False, True, False)[:3]
    yf, mf, vf = K.bn_fwd(xb.float(), *args, EPS, False, True, False)[:3]
    assert yb.dtype == torch.bfloat16 and mb.dtype == torch.float32
    assert torch.equal(mb, mf) and torch.equal(vb, vf)
    np.testing.assert_allclose(yb.float().numpy(), yf.numpy(),
                               rtol=2 ** -8, atol=1e-6)
