"""The image-classification model zoo on the port's v2 layer API — the
port of ``paddle_tpu/models/image.py`` (≅ the reference's
``benchmark/paddle/image/{alexnet,vgg,resnet,googlenet,
smallnet_mnist_cifar}.py``).

Each builder returns ``(predict, img, label)``; the ``*_cost`` variants
append the benchmark's loss (``_with_cost``) so a Topology can be trained
directly.  Layer, parameter and state names equal the JAX package's
(AlexNet 16 parameters, VGG-19 38, ResNet-50 161 with 106 states,
GoogLeNet 116)."""

from __future__ import annotations

from paddle_tpu_torch.layers import activation as act
from paddle_tpu_torch.layers import api as layer
from paddle_tpu_torch.layers import data_type
from paddle_tpu_torch.layers import pooling
from paddle_tpu_torch.layers.attr import ExtraAttr
from paddle_tpu_torch.layers.networks import img_conv_group


def _img_data(height: int, width: int, channels: int = 3):
    return layer.data(
        name="image",
        type=data_type.dense_vector(height * width * channels,
                                    channels=channels),
        height=height,
        width=width,
    )


# ---------------------------------------------------------------- AlexNet ----
def alexnet(img=None, class_num: int = 1000, height: int = 227,
            width: int = 227):
    """≅ benchmark/paddle/image/alexnet.py (five convs, two LRNs, three
    fc with dropout 0.5 on fc6 and fc7)."""
    if img is None:
        img = _img_data(height, width)
    net = layer.img_conv(input=img, filter_size=11, num_channels=3,
                         num_filters=96, stride=4, padding=1, name="conv1")
    net = layer.img_cmrnorm(input=net, size=5, scale=0.0001, power=0.75,
                            name="norm1")
    net = layer.img_pool(input=net, pool_size=3, stride=2, name="pool1")
    net = layer.img_conv(input=net, filter_size=5, num_filters=256,
                         stride=1, padding=2, name="conv2")
    net = layer.img_cmrnorm(input=net, size=5, scale=0.0001, power=0.75,
                            name="norm2")
    net = layer.img_pool(input=net, pool_size=3, stride=2, name="pool2")
    net = layer.img_conv(input=net, filter_size=3, num_filters=384,
                         stride=1, padding=1, name="conv3")
    net = layer.img_conv(input=net, filter_size=3, num_filters=384,
                         stride=1, padding=1, name="conv4")
    net = layer.img_conv(input=net, filter_size=3, num_filters=256,
                         stride=1, padding=1, name="conv5")
    net = layer.img_pool(input=net, pool_size=3, stride=2, name="pool5")
    net = layer.fc(input=net, size=4096, act=act.ReluActivation(),
                   layer_attr=ExtraAttr(drop_rate=0.5), name="fc6")
    net = layer.fc(input=net, size=4096, act=act.ReluActivation(),
                   layer_attr=ExtraAttr(drop_rate=0.5), name="fc7")
    predict = layer.fc(input=net, size=class_num,
                       act=act.SoftmaxActivation(), name="fc8")
    label = layer.data(name="label", type=data_type.integer_value(class_num))
    return predict, img, label


# -------------------------------------------------------------------- VGG ----
def vgg(img=None, class_num: int = 1000, depth: int = 19,
        height: int = 224, width: int = 224):
    """≅ benchmark/paddle/image/vgg.py (``img_conv_group`` stacks without
    batch norm, then two fc 4096 with dropout 0.5)."""
    if img is None:
        img = _img_data(height, width)
    vgg_num = {16: 3, 19: 4}[depth]
    net = img_conv_group(
        input=img, num_channels=3, conv_padding=1, conv_num_filter=[64, 64],
        conv_filter_size=3, conv_act=act.ReluActivation(), pool_size=2,
        pool_stride=2, pool_type=pooling.MaxPooling())
    net = img_conv_group(
        input=net, conv_padding=1, conv_num_filter=[128, 128],
        conv_filter_size=3, conv_act=act.ReluActivation(), pool_size=2,
        pool_stride=2, pool_type=pooling.MaxPooling())
    for ch in (256, 512, 512):
        net = img_conv_group(
            input=net, conv_padding=1, conv_num_filter=[ch] * vgg_num,
            conv_filter_size=3, conv_act=act.ReluActivation(), pool_size=2,
            pool_stride=2, pool_type=pooling.MaxPooling())
    net = layer.fc(input=net, size=4096, act=act.ReluActivation(),
                   layer_attr=ExtraAttr(drop_rate=0.5), name="fc6")
    net = layer.fc(input=net, size=4096, act=act.ReluActivation(),
                   layer_attr=ExtraAttr(drop_rate=0.5), name="fc7")
    predict = layer.fc(input=net, size=class_num,
                       act=act.SoftmaxActivation(), name="fc8")
    label = layer.data(name="label", type=data_type.integer_value(class_num))
    return predict, img, label


# ----------------------------------------------------------------- ResNet ----
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


# -------------------------------------------------------------- GoogLeNet ----
def _inception(name, input, channels, f1, f3r, f3, f5r, f5, proj):
    cov1 = layer.img_conv(name=name + "_1", input=input, filter_size=1,
                          num_channels=channels, num_filters=f1, stride=1,
                          padding=0)
    cov3r = layer.img_conv(name=name + "_3r", input=input, filter_size=1,
                           num_channels=channels, num_filters=f3r, stride=1,
                           padding=0)
    cov3 = layer.img_conv(name=name + "_3", input=cov3r, filter_size=3,
                          num_filters=f3, stride=1, padding=1)
    cov5r = layer.img_conv(name=name + "_5r", input=input, filter_size=1,
                           num_channels=channels, num_filters=f5r, stride=1,
                           padding=0)
    cov5 = layer.img_conv(name=name + "_5", input=cov5r, filter_size=5,
                          num_filters=f5, stride=1, padding=2)
    pool1 = layer.img_pool(name=name + "_max", input=input, pool_size=3,
                           num_channels=channels, stride=1, padding=1)
    covprj = layer.img_conv(name=name + "_proj", input=pool1, filter_size=1,
                            num_filters=proj, stride=1, padding=0)
    return layer.concat(name=name, input=[cov1, cov3, cov5, covprj])


def googlenet(img=None, class_num: int = 1000, height: int = 224,
              width: int = 224):
    """≅ benchmark/paddle/image/googlenet.py (Inception-v1, main branch
    only)."""
    if img is None:
        img = _img_data(height, width)
    conv1 = layer.img_conv(name="conv1", input=img, filter_size=7,
                           num_channels=3, num_filters=64, stride=2,
                           padding=3)
    pool1 = layer.img_pool(name="pool1", input=conv1, pool_size=3, stride=2)
    conv2_1 = layer.img_conv(name="conv2_1", input=pool1, filter_size=1,
                             num_filters=64, stride=1, padding=0)
    conv2_2 = layer.img_conv(name="conv2_2", input=conv2_1, filter_size=3,
                             num_filters=192, stride=1, padding=1)
    pool2 = layer.img_pool(name="pool2", input=conv2_2, pool_size=3,
                           stride=2)
    ince3a = _inception("ince3a", pool2, 192, 64, 96, 128, 16, 32, 32)
    ince3b = _inception("ince3b", ince3a, 256, 128, 128, 192, 32, 96, 64)
    pool3 = layer.img_pool(name="pool3", input=ince3b, pool_size=3, stride=2)
    ince4a = _inception("ince4a", pool3, 480, 192, 96, 208, 16, 48, 64)
    ince4b = _inception("ince4b", ince4a, 512, 160, 112, 224, 24, 64, 64)
    ince4c = _inception("ince4c", ince4b, 512, 128, 128, 256, 24, 64, 64)
    ince4d = _inception("ince4d", ince4c, 512, 112, 144, 288, 32, 64, 64)
    ince4e = _inception("ince4e", ince4d, 528, 256, 160, 320, 32, 128, 128)
    pool4 = layer.img_pool(name="pool4", input=ince4e, pool_size=3, stride=2)
    ince5a = _inception("ince5a", pool4, 832, 256, 160, 320, 32, 128, 128)
    ince5b = _inception("ince5b", ince5a, 832, 384, 192, 384, 48, 128, 128)
    pool5 = layer.img_pool(name="pool5", input=ince5b, pool_size=7, stride=7,
                           pool_type=pooling.AvgPooling())
    dropped = layer.dropout(input=pool5, dropout_rate=0.4, name="dropout")
    predict = layer.fc(input=dropped, size=class_num,
                       act=act.SoftmaxActivation(), name="fc_out")
    label = layer.data(name="label", type=data_type.integer_value(class_num))
    return predict, img, label


# ---------------------------------------------------------------- SmallNet ----
def smallnet(img=None, class_num: int = 10, height: int = 32,
             width: int = 32):
    """≅ benchmark/paddle/image/smallnet_mnist_cifar.py (cifar10-quick)."""
    if img is None:
        img = _img_data(height, width)
    net = layer.img_conv(input=img, filter_size=5, num_channels=3,
                         num_filters=32, stride=1, padding=2, name="conv1")
    net = layer.img_pool(input=net, pool_size=3, stride=2, padding=1,
                         name="pool1")
    net = layer.img_conv(input=net, filter_size=5, num_filters=32, stride=1,
                         padding=2, name="conv2")
    net = layer.img_pool(input=net, pool_size=3, stride=2, padding=1,
                         pool_type=pooling.AvgPooling(), name="pool2")
    net = layer.img_conv(input=net, filter_size=3, num_filters=64, stride=1,
                         padding=1, name="conv3")
    net = layer.img_pool(input=net, pool_size=3, stride=2, padding=1,
                         pool_type=pooling.AvgPooling(), name="pool3")
    net = layer.fc(input=net, size=64, act=act.ReluActivation(), name="fc1")
    predict = layer.fc(input=net, size=class_num,
                       act=act.SoftmaxActivation(), name="fc2")
    label = layer.data(name="label", type=data_type.integer_value(class_num))
    return predict, img, label


# ------------------------------------------------------------------ costs ----
def _with_cost(builder, cost_kind: str = "cross_entropy", **kw):
    """``(cost, predict, img, label)``: the builder's net with the
    cross-entropy cost named ``loss``, or ``classification_cost``."""
    predict, img, label = builder(**kw)
    if cost_kind == "classification":
        cost = layer.classification_cost(input=predict, label=label)
    else:
        cost = layer.cross_entropy_cost(input=predict, label=label,
                                        name="loss")
    return cost, predict, img, label


def alexnet_cost(**kw):
    return _with_cost(alexnet, **kw)


def vgg_cost(**kw):
    return _with_cost(vgg, **kw)


def resnet_cost(**kw):
    return _with_cost(resnet, **kw)


def googlenet_cost(**kw):
    return _with_cost(googlenet, **kw)


def smallnet_cost(**kw):
    return _with_cost(smallnet, cost_kind="classification", **kw)
