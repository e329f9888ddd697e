"""ResNeXt (example/image-classification/symbols/resnext.py; Xie et al.
2017 "Aggregated Residual Transformations"), as the JAX package's
``models/resnext.py`` builds it.

Post-activation bottleneck units whose 3x3 stage is a grouped
convolution with ``num_group`` cardinality (``Convolution``'s
``num_group``). The filter schedule and the layer names are the JAX
package's, so parameters cross between the packages by name.
"""
from .. import symbol as sym


def resnext_unit(data, num_filter, stride, dim_match, name, num_group,
                 bottle_neck=True, bn_mom=0.9, workspace=256):
    if bottle_neck:
        conv1 = sym.Convolution(data=data, num_filter=num_filter // 2,
                                kernel=(1, 1), stride=(1, 1), pad=(0, 0),
                                no_bias=True, workspace=workspace,
                                name=name + "_conv1")
        bn1 = sym.BatchNorm(data=conv1, fix_gamma=False, eps=2e-5,
                            momentum=bn_mom, name=name + "_bn1")
        act1 = sym.Activation(data=bn1, act_type="relu",
                              name=name + "_relu1")
        conv2 = sym.Convolution(data=act1, num_filter=num_filter // 2,
                                num_group=num_group, kernel=(3, 3),
                                stride=stride, pad=(1, 1), no_bias=True,
                                workspace=workspace, name=name + "_conv2")
        bn2 = sym.BatchNorm(data=conv2, fix_gamma=False, eps=2e-5,
                            momentum=bn_mom, name=name + "_bn2")
        act2 = sym.Activation(data=bn2, act_type="relu",
                              name=name + "_relu2")
        conv3 = sym.Convolution(data=act2, num_filter=num_filter,
                                kernel=(1, 1), stride=(1, 1), pad=(0, 0),
                                no_bias=True, workspace=workspace,
                                name=name + "_conv3")
        bn3 = sym.BatchNorm(data=conv3, fix_gamma=False, eps=2e-5,
                            momentum=bn_mom, name=name + "_bn3")
        if dim_match:
            shortcut = data
        else:
            sc = sym.Convolution(data=data, num_filter=num_filter,
                                 kernel=(1, 1), stride=stride,
                                 no_bias=True, workspace=workspace,
                                 name=name + "_sc")
            shortcut = sym.BatchNorm(data=sc, fix_gamma=False, eps=2e-5,
                                     momentum=bn_mom,
                                     name=name + "_sc_bn")
        return sym.Activation(data=bn3 + shortcut, act_type="relu",
                              name=name + "_relu")
    conv1 = sym.Convolution(data=data, num_filter=num_filter,
                            kernel=(3, 3), stride=stride, pad=(1, 1),
                            no_bias=True, workspace=workspace,
                            name=name + "_conv1")
    bn1 = sym.BatchNorm(data=conv1, fix_gamma=False, eps=2e-5,
                        momentum=bn_mom, name=name + "_bn1")
    act1 = sym.Activation(data=bn1, act_type="relu",
                          name=name + "_relu1")
    conv2 = sym.Convolution(data=act1, num_filter=num_filter,
                            kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                            no_bias=True, workspace=workspace,
                            name=name + "_conv2")
    bn2 = sym.BatchNorm(data=conv2, fix_gamma=False, eps=2e-5,
                        momentum=bn_mom, name=name + "_bn2")
    if dim_match:
        shortcut = data
    else:
        sc = sym.Convolution(data=data, num_filter=num_filter,
                             kernel=(1, 1), stride=stride, no_bias=True,
                             workspace=workspace, name=name + "_sc")
        shortcut = sym.BatchNorm(data=sc, fix_gamma=False, eps=2e-5,
                                 momentum=bn_mom, name=name + "_sc_bn")
    return sym.Activation(data=bn2 + shortcut, act_type="relu",
                          name=name + "_relu")


# depth -> (bottleneck, per-stage unit counts), ImageNet schedules
_DEPTHS = {
    18: (False, [2, 2, 2, 2]),
    34: (False, [3, 4, 6, 3]),
    50: (True, [3, 4, 6, 3]),
    101: (True, [3, 4, 23, 3]),
    152: (True, [3, 8, 36, 3]),
}


def get_symbol(num_classes=1000, num_layers=50, num_group=32, bn_mom=0.9,
               workspace=256, image_shape=(3, 224, 224)):
    if isinstance(image_shape, str):
        image_shape = tuple(int(x) for x in image_shape.split(","))
    height = image_shape[1]
    if height <= 28:
        # cifar schedules (reference resnext.py: 3 stages, depth tables
        # like resnet's — resnext-29 = 3 bottleneck units per stage)
        if (num_layers - 2) % 9 == 0:
            bottle_neck = True
            units = [(num_layers - 2) // 9] * 3
            filter_list = [16, 64, 128, 256]
        elif (num_layers - 2) % 6 == 0:
            bottle_neck = False
            units = [(num_layers - 2) // 6] * 3
            filter_list = [16, 16, 32, 64]
        else:
            raise ValueError("no cifar resnext-%d schedule" % num_layers)
    elif num_layers in _DEPTHS:
        bottle_neck, units = _DEPTHS[num_layers]
        filter_list = [64, 256, 512, 1024, 2048] if bottle_neck else \
            [64, 64, 128, 256, 512]
    else:
        raise ValueError("no resnext-%d schedule" % num_layers)

    data = sym.Variable("data")
    data = sym.BatchNorm(data=data, fix_gamma=True, eps=2e-5,
                         momentum=bn_mom, name="bn_data")
    if height <= 32:  # cifar stem (reference resnext.py)
        body = sym.Convolution(data=data, num_filter=filter_list[0],
                               kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                               no_bias=True, workspace=workspace,
                               name="conv0")
    else:  # imagenet stem
        body = sym.Convolution(data=data, num_filter=filter_list[0],
                               kernel=(7, 7), stride=(2, 2), pad=(3, 3),
                               no_bias=True, workspace=workspace,
                               name="conv0")
        body = sym.BatchNorm(data=body, fix_gamma=False, eps=2e-5,
                             momentum=bn_mom, name="bn0")
        body = sym.Activation(data=body, act_type="relu", name="relu0")
        body = sym.Pooling(data=body, kernel=(3, 3), stride=(2, 2),
                           pad=(1, 1), pool_type="max")

    for i, n_unit in enumerate(units):
        stride = (1, 1) if i == 0 else (2, 2)
        body = resnext_unit(body, filter_list[i + 1], stride, False,
                            "stage%d_unit1" % (i + 1), num_group,
                            bottle_neck, bn_mom, workspace)
        for j in range(n_unit - 1):
            body = resnext_unit(body, filter_list[i + 1], (1, 1), True,
                                "stage%d_unit%d" % (i + 1, j + 2),
                                num_group, bottle_neck, bn_mom, workspace)

    pool = sym.Pooling(data=body, global_pool=True, kernel=(7, 7),
                       pool_type="avg", name="pool1")
    flat = sym.Flatten(data=pool)
    fc1 = sym.FullyConnected(data=flat, num_hidden=num_classes,
                             name="fc1")
    return sym.SoftmaxOutput(data=fc1, name="softmax")
