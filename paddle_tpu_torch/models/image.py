"""ResNet on the port's v2 layer API — the port of the ResNet part of
``paddle_tpu/models/image.py`` (≅ ``benchmark/paddle/image/resnet.py``).

``resnet`` returns ``(predict, img, label)``; ``resnet_cost`` appends the
cross-entropy loss so a Topology can be trained directly.  Layer,
parameter and state names equal the JAX package's (161 parameters and
106 states for depth 50)."""

from __future__ import annotations

from paddle_tpu_torch.layers import activation as act
from paddle_tpu_torch.layers import api as layer
from paddle_tpu_torch.layers import data_type
from paddle_tpu_torch.layers import pooling


def _img_data(height: int, width: int, channels: int = 3):
    return layer.data(
        name="image",
        type=data_type.dense_vector(height * width * channels,
                                    channels=channels),
        height=height,
        width=width,
    )


def _conv_bn(name, input, filter_size, num_filters, stride, padding,
             channels=None, active_type=None):
    """One fused conv+BN+act node (``layer.img_conv_bn``)."""
    return layer.img_conv_bn(
        name=name, input=input, filter_size=filter_size,
        num_channels=channels, num_filters=num_filters, stride=stride,
        padding=padding,
        act=active_type if active_type is not None else act.ReluActivation(),
    )


def _bottleneck(name, input, num_filters1, num_filters2):
    tmp = _conv_bn(name + "_branch2a", input, 1, num_filters1, 1, 0)
    tmp = _conv_bn(name + "_branch2b", tmp, 3, num_filters1, 1, 1)
    tmp = _conv_bn(name + "_branch2c", tmp, 1, num_filters2, 1, 0,
                   active_type=act.LinearActivation())
    return layer.addto(name=name + "_addto", input=[input, tmp],
                       act=act.ReluActivation())


def _mid_projection(name, input, num_filters1, num_filters2, stride=2):
    branch1 = _conv_bn(name + "_branch1", input, 1, num_filters2, stride, 0,
                       active_type=act.LinearActivation())
    tmp = _conv_bn(name + "_branch2a", input, 1, num_filters1, stride, 0)
    tmp = _conv_bn(name + "_branch2b", tmp, 3, num_filters1, 1, 1)
    tmp = _conv_bn(name + "_branch2c", tmp, 1, num_filters2, 1, 0,
                   active_type=act.LinearActivation())
    return layer.addto(name=name + "_addto", input=[branch1, tmp],
                       act=act.ReluActivation())


_RESNET_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def resnet(img=None, class_num: int = 1000, depth: int = 50,
           height: int = 224, width: int = 224):
    """≅ benchmark/paddle/image/resnet.py deep_res_net (bottleneck
    50/101/152)."""
    if img is None:
        img = _img_data(height, width)
    n2, n3, n4, n5 = _RESNET_BLOCKS[depth]
    tmp = _conv_bn("conv1", img, 7, 64, 2, 3, channels=3)
    tmp = layer.img_pool(name="pool1", input=tmp, pool_size=3, stride=2)
    stages = [
        ("res2", n2, 64, 256, 1),
        ("res3", n3, 128, 512, 2),
        ("res4", n4, 256, 1024, 2),
        ("res5", n5, 512, 2048, 2),
    ]
    for sname, num, f1, f2, stride in stages:
        tmp = _mid_projection(f"{sname}_1", tmp, f1, f2, stride=stride)
        for i in range(2, num + 1):
            tmp = _bottleneck(f"{sname}_{i}", tmp, f1, f2)
    tmp = layer.img_pool(name="avgpool", input=tmp, pool_size=7, stride=1,
                         pool_type=pooling.AvgPooling())
    predict = layer.fc(input=tmp, size=class_num,
                       act=act.SoftmaxActivation(), name="fc_out")
    label = layer.data(name="label", type=data_type.integer_value(class_num))
    return predict, img, label


def resnet_cost(**kw):
    """``(cost, predict, img, label)`` with the cross-entropy cost named
    ``loss``."""
    predict, img, label = resnet(**kw)
    cost = layer.cross_entropy_cost(input=predict, label=label, name="loss")
    return cost, predict, img, label
