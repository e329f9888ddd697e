"""The Caffe and OpenCV plugins and the torch bridge of the PyTorch port
(``mxnet_tpu_torch.plugin.caffe``, ``.plugin.opencv``, ``.torch_bridge``
as ``mx.torch``) against the JAX package's, on the CPU.

* ``CaffeOp``: every supported layer type, read by the port's own
  prototxt reader, lowers to the JAX package's graph node for node (op,
  name, attributes); a net of Caffe layers computes the JAX net's
  outputs; ``num_weight`` is checked as the JAX plugin checks it;
  ``CaffeLoss`` is its ``SoftmaxOutput``; both refuse what it refuses.
* OpenCV: ``imdecode`` (colour and grey), ``resize``,
  ``copyMakeBorder``, ``fixed_crop`` (with and without ``size``),
  ``random_crop`` from one seed and ``ImageListIter`` bit for bit.
* ``TorchModule``/``TorchCriterion``: the arguments, output shapes,
  forward and gradients of a net of PyTorch layers with a criterion
  head, within 1e-6; a stochastic layer repeats from one key;
  ``pytorch_function`` keeps the tensors where they are.
* The twins of ``example/caffe/train_caffe_net.py`` and
  ``example/torch/torch_module.py`` pass the JAX scripts' asserts.
"""
import json
import random

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.plugin  # noqa: F401  (registers CaffeOp on mx.sym)
from mxnet_tpu.name import NameManager as JNameManager
from mxnet_tpu.plugin import opencv as jcv

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.name import NameManager as TNameManager
from mxnet_tpu_torch.plugin import caffe as tcaffe
from mxnet_tpu_torch.plugin import opencv as tcv

torch.set_num_threads(2)

CPU = tmx.cpu()

LAYERS = [
    'layer{type:"InnerProduct" inner_product_param{num_output: 10}}',
    'layer{type:"InnerProduct" name: "ip" inner_product_param{'
    'num_output: 7 bias_term: false}}',
    'layer{type:"Convolution" convolution_param{num_output: 4 '
    'kernel_size: 3 stride: 2 pad: 1 group: 2}}',
    'layer { type: "Convolution" convolution_param { num_output: 4 '
    'kernel_h: 3 kernel_w: 1 pad_h: 0 pad_w: 3 dilation: 2 } }',
    'layer{type:"Deconvolution" convolution_param{num_output: 2 '
    'kernel_size: 2 stride: 2}}',
    'layer{type:"Pooling" pooling_param{pool: MAX kernel_size: 2 '
    'stride: 2}}',
    'layer{type:"Pooling" pooling_param{pool: AVE kernel_size: 3 pad: 1}}',
    'layer{type:"Pooling" pooling_param{pool: AVE global_pooling: true}}',
    'layer{type:"ReLU"}', 'layer{type:"Sigmoid"}', 'layer{type:"TanH"}',
    'layer{type:"LRN" lrn_param{local_size: 3 alpha: 0.0001 beta: 0.75}}',
    'layer{type:"Dropout" dropout_param{dropout_ratio: 0.3}}',
    'layer{type:"BatchNorm" name: "bn" batch_norm_param{'
    'moving_average_fraction: 0.9 eps: 0.001}}',
    'layer{type:"Flatten"}',
    'layer{type:"Reshape" reshape_param{shape{dim: 0 dim: -1}}}',
    'layer{type:"Softmax"}',
    'layer{type:"SoftmaxWithLoss"}',
    '# a comment\ntype: "Concat" concat_param { axis: 1 }',
    'layer{type:"Eltwise" eltwise_param{operation: SUM coeff: 0.5 '
    'coeff: 2}}',
    'layer{type:"Eltwise" eltwise_param{operation: PROD}}',
    'layer{type:"Eltwise" eltwise_param{operation: MAX}}',
]


def _nodes(sym):
    return [(n["op"], n["name"], n.get("attrs", n.get("attr", {})),
             n["inputs"]) for n in json.loads(sym.tojson())["nodes"]]


def _caffe(mx, names, prototxt, **kw):
    with names():
        a = mx.sym.Variable("a")
        ins = [a, mx.sym.Variable("b")] if ("Concat" in prototxt or
                                            "Eltwise" in prototxt) else [a]
        return mx.sym.CaffeOp(*ins, prototxt=prototxt, **kw)


@pytest.mark.parametrize("prototxt", LAYERS)
def test_caffe_layer_lowers_to_the_jax_graph(prototxt):
    t = _caffe(tmx, TNameManager, prototxt)
    j = _caffe(jmx, JNameManager, prototxt)
    assert _nodes(t) == _nodes(j)
    assert t.list_arguments() == j.list_arguments()


def _caffe_mlp(mx, names):
    with names():
        data = mx.sym.Variable("data")
        net = mx.sym.CaffeOp(data, num_weight=2, name="fc1", prototxt=(
            'layer{type:"InnerProduct" inner_product_param{'
            'num_output: 8}}'))
        net = mx.sym.CaffeOp(net, prototxt='layer{type:"TanH"}')
        net = mx.sym.CaffeOp(net, num_weight=2, name="fc2", prototxt=(
            'layer{type:"InnerProduct" inner_product_param{'
            'num_output: 3}}'))
        return mx.plugin.CaffeLoss(net, mx.sym.Variable("softmax_label"),
                                   grad_scale=0.5)


def _run(mx, sym, arrays):
    ex = sym.simple_bind(mx.cpu(), **{k: v.shape for k, v in
                                      arrays.items()})
    for k, v in arrays.items():
        ex.arg_dict[k][:] = v
    ex.forward(is_train=True)
    ex.backward()
    return ([o.asnumpy() for o in ex.outputs],
            {k: g.asnumpy() for k, g in ex.grad_dict.items()
             if g is not None})


def test_caffe_net_computes_the_jax_net():
    t, j = _caffe_mlp(tmx, TNameManager), _caffe_mlp(jmx, JNameManager)
    assert _nodes(t) == _nodes(j)
    shapes = dict(zip(t.list_arguments(),
                      t.infer_shape(data=(4, 5))[0]))
    rs = np.random.RandomState(0)
    arrays = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    arrays["softmax_label"] = np.array([0, 2, 1, 2], np.float32)
    (to,), tg = _run(tmx, t, arrays)
    (jo,), jg = _run(jmx, j, arrays)
    np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-6)
    for k in ("fc1_weight", "fc2_bias", "data"):
        np.testing.assert_allclose(tg[k], jg[k], rtol=1e-5, atol=1e-6)


def test_caffe_refusals_match_jax():
    bad = [dict(prototxt='layer{type:"InnerProduct" inner_product_param{'
                         'num_output: 3 bias_term: false}}', num_weight=2),
           dict(prototxt='layer{type:"Crop"}'),
           dict(prototxt='layer{name: "x"}'),
           dict(prototxt='layer{type:"Pooling" pooling_param{'
                         'pool: STOCHASTIC kernel_size: 2}}'),
           dict(prototxt='layer{type:"TanH"}', num_out=2)]
    for kw in bad:
        for mx, names in ((tmx, TNameManager), (jmx, JNameManager)):
            with pytest.raises(ValueError):
                _caffe(mx, names, **kw)
    for mx in (tmx, jmx):
        with pytest.raises(ValueError):
            mx.plugin.CaffeLoss(mx.sym.Variable("d"), mx.sym.Variable("l"),
                                prototxt='layer{type:"EuclideanLoss"}')
    lay = tcaffe.parse_layer('type: "Convolution" convolution_param '
                             '{ kernel_size: [3, 5] }')
    assert tcaffe._pair(lay.convolution_param, "kernel_size", 1,
                        "kernel") == (3, 5)
    assert lay.convolution_param.bias_term is True   # the schema's default


# ---------------------------------------------------------------- opencv
def _png(arr):
    import cv2
    return cv2.imencode(".png", arr)[1].tobytes()


def test_opencv_functions_bitwise_the_jax_plugin():
    rs = np.random.RandomState(4)
    img_np = rs.randint(0, 256, (37, 29, 3)).astype(np.uint8)
    buf = _png(img_np)
    t_img, j_img = tcv.imdecode(buf), jcv.imdecode(buf)
    assert t_img.context == CPU and t_img.dtype == np.uint8
    np.testing.assert_array_equal(t_img.asnumpy(), j_img.asnumpy())
    np.testing.assert_array_equal(t_img.asnumpy(), img_np)   # BGR as cv2
    np.testing.assert_array_equal(tcv.imdecode(buf, 0).asnumpy(),
                                  jcv.imdecode(buf, 0).asnumpy())
    for interp in (0, 1, 2):
        np.testing.assert_array_equal(
            tcv.resize(t_img, (15, 11), interp).asnumpy(),
            jcv.resize(j_img, (15, 11), interp).asnumpy())
    for btype in (0, 1):
        np.testing.assert_array_equal(
            tcv.copyMakeBorder(t_img, 1, 2, 3, 4, btype, 9).asnumpy(),
            jcv.copyMakeBorder(j_img, 1, 2, 3, 4, btype, 9).asnumpy())
    for size in (None, (8, 6)):
        np.testing.assert_array_equal(
            tcv.fixed_crop(t_img, 2, 3, 10, 12, size).asnumpy(),
            jcv.fixed_crop(j_img, 2, 3, 10, 12, size).asnumpy())
    assert tcv.scale_down((20, 10), (30, 30)) == \
        jcv.scale_down((20, 10), (30, 30))
    random.seed(5)
    t_crop, t_box = tcv.random_crop(t_img, (9, 7))
    random.seed(5)
    j_crop, j_box = jcv.random_crop(j_img, (9, 7))
    assert t_box == j_box
    np.testing.assert_array_equal(t_crop.asnumpy(), j_crop.asnumpy())


def test_image_list_iter_bitwise_the_jax_one(tmp_path):
    rs = np.random.RandomState(6)
    lines = []
    for i in range(5):
        name = "im%d.png" % i
        with open(str(tmp_path / name), "wb") as f:
            f.write(_png(rs.randint(0, 256, (20 + i, 16, 3)).astype(
                np.uint8)))
        lines.append("%d\t%s" % (i % 3, name))
    kw = dict(batch_size=2, size=(12, 10), mean=[1.0, 2.0, 3.0])
    t_it = tcv.ImageListIter(str(tmp_path), lines, **kw)
    j_it = jcv.ImageListIter(str(tmp_path), lines, **kw)
    assert t_it.provide_data == j_it.provide_data
    for _ in range(2):
        tb, jb = t_it.next(), j_it.next()
        np.testing.assert_array_equal(tb.data[0].asnumpy(),
                                      jb.data[0].asnumpy())
        np.testing.assert_array_equal(tb.label[0].asnumpy(),
                                      jb.label[0].asnumpy())
    with pytest.raises(StopIteration):
        t_it.next()


def test_decode_without_an_image_library_names_both(monkeypatch):
    import builtins
    real = builtins.__import__

    def no_images(name, *a, **kw):
        if name in ("cv2", "PIL") or name.startswith("PIL."):
            raise ImportError(name)
        return real(name, *a, **kw)

    img = tmx.nd.array(np.zeros((4, 4, 3), np.uint8), ctx=CPU,
                       dtype=np.uint8)
    monkeypatch.setattr(builtins, "__import__", no_images)
    for fn in (lambda: tcv.imdecode(b"\x89PNG"),
               lambda: tcv.resize(img, (2, 2))):
        with pytest.raises(tmx.MXNetError, match="cv2.*PIL"):
            fn()
    assert tcv.copyMakeBorder(img, 1, 1, 1, 1).shape == (6, 6, 3)


# ----------------------------------------------------------- torch bridge
def _torch_net(mx, names, criterion):
    with names():
        net = mx.sym.TorchModule(data_0=mx.sym.Variable("data"),
                                 lua_string="nn.Linear(6, 5)", num_data=1,
                                 num_params=2, num_outputs=1, name="fc")
        net = mx.sym.TorchModule(data_0=net, lua_string="nn.Tanh()",
                                 num_data=1, num_params=0, num_outputs=1,
                                 name="act")
        if criterion == "nll":
            net = mx.sym.TorchModule(data_0=net,
                                     lua_string="nn.LogSoftmax(dim=1)",
                                     num_data=1, num_params=0,
                                     num_outputs=1, name="lsm")
            return mx.sym.TorchCriterion(
                data=net, label=mx.sym.Variable("softmax_label"),
                lua_string="nn.NLLLoss()", grad_scale=2.0, name="loss")
        return mx.sym.TorchCriterion(
            data=net, label=mx.sym.Variable("target"),
            lua_string="nn.MSELoss()", label_shape=(5,), name="loss")


@pytest.mark.parametrize("criterion", ["nll", "mse"])
def test_torch_module_and_criterion_against_jax(criterion):
    t = _torch_net(tmx, TNameManager, criterion)
    j = _torch_net(jmx, JNameManager, criterion)
    assert t.list_arguments() == j.list_arguments()
    t_shapes = t.infer_shape(data=(4, 6))
    assert t_shapes == j.infer_shape(data=(4, 6))
    rs = np.random.RandomState(8)
    arrays = {k: rs.randn(*s).astype(np.float32)
              for k, s in zip(t.list_arguments(), t_shapes[0])}
    if criterion == "nll":
        arrays["softmax_label"] = np.array([0, 4, 1, 3], np.float32)
    (to,), tg = _run(tmx, t, arrays)
    (jo,), jg = _run(jmx, j, arrays)
    assert to.shape == (4,) and np.allclose(to, to[0])
    np.testing.assert_allclose(to, jo, rtol=1e-6, atol=1e-6)
    assert sorted(tg) == sorted(jg)
    for k in tg:
        np.testing.assert_allclose(tg[k], jg[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_torch_module_dropout_repeats_from_one_key():
    sym = tmx.sym.TorchModule(data_0=tmx.sym.Variable("data"),
                              lua_string="nn.Dropout(0.5)", num_data=1,
                              num_params=0, num_outputs=1)
    x = np.ones((8, 16), np.float32)
    outs = []
    for _ in range(2):
        tmx.random.seed(3)
        ex = sym.simple_bind(CPU, data=x.shape)
        ex.arg_dict["data"][:] = x
        ex.forward(is_train=True)
        outs.append(ex.outputs[0].asnumpy())
        ex.forward(is_train=False)
        np.testing.assert_array_equal(ex.outputs[0].asnumpy(), x)
    np.testing.assert_array_equal(outs[0], outs[1])
    assert set(np.unique(outs[0])) == {0.0, 2.0}


def test_pytorch_function_and_the_mx_torch_name():
    assert tmx.torch.pytorch_function is not None
    assert tmx.torch is not torch and tmx.torch.__name__.endswith(
        "torch_bridge")
    fn = tmx.torch.pytorch_function(lambda a, b: (a * b, a + b))
    jfn = jmx.torch.pytorch_function(lambda a, b: (a * b, a + b))
    a, b = np.arange(6, dtype=np.float32), np.full(6, 2.0, np.float32)
    t_out = fn(tmx.nd.array(a, ctx=CPU), tmx.nd.array(b, ctx=CPU))
    j_out = jfn(jmx.nd.array(a), jmx.nd.array(b))
    assert [o.context for o in t_out] == [CPU, CPU]
    for t, j in zip(t_out, j_out):
        np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())


# ---------------------------------------------------------------- twins
@pytest.mark.parametrize("argv", [[], ["--network", "lenet",
                                       "--use-caffe-loss"]])
def test_train_caffe_net_twin(argv):
    from mxnet_tpu_torch.examples import train_caffe_net
    res = train_caffe_net.main(["--cpu"] + argv)
    assert res["accuracy"] > 0.5


@pytest.mark.parametrize("argv", [[], ["--use-torch-criterion"]])
def test_torch_module_twin(argv):
    from mxnet_tpu_torch.examples import torch_module
    res = torch_module.main(["--cpu"] + argv)
    assert res["accuracy"] > 0.8
