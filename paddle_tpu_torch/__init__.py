"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu`` for one
NVIDIA H100.

``paddle_tpu`` (JAX, TPU) stays the reference; this package imports
``torch`` and ``numpy`` and nothing of JAX or ``paddle_tpu``.  Every
Pallas kernel on a ported path has a hand-written CUDA counterpart under
``ops/kernels/csrc/``, built with ``nvcc`` at first use.  Entry points
run on the card unless the caller passes ``device="cpu"``.

Ported so far: online serving of the transformer LM
(``paddle_tpu_torch.serving``), its training
(``models.transformer.build_train_step``), v2 training through
``trainer.SGD`` of ResNet, of the LSTM text classifier
(``layer.embedding``, ``layer.lstmemory``, ``layer.last_seq``,
``layer.classification_cost`` over ``data_type.integer_value_sequence``)
and of the OCR CRNN (``models.ocr_crnn``: ``layer.bilstm``,
``layers.extras.ctc``), and ``paddle.infer``::

    import paddle_tpu_torch as paddle
    cost, predict, img, label = paddle.models.image.resnet_cost(depth=50)
    params = paddle.parameters.create(cost)
    trainer = paddle.trainer.SGD(cost=cost, parameters=params,
        update_equation=paddle.optimizer.Momentum(momentum=0.9,
                                                  learning_rate=0.1 / 64))
    trainer.train(reader=paddle.batch(reader, 64), num_passes=1)

The v2 names resolve lazily, so importing the package (or its serving
path) does not load the layer API."""

import importlib as _importlib

__version__ = "0.1.0"

# v2 module names -> implementation modules (as paddle_tpu/__init__.py)
_API_MAP = {
    "layer": "paddle_tpu_torch.layers.api",
    "topology": "paddle_tpu_torch.config.topology",
    "activation": "paddle_tpu_torch.layers.activation",
    "pooling": "paddle_tpu_torch.layers.pooling",
    "attr": "paddle_tpu_torch.layers.attr",
    "data_type": "paddle_tpu_torch.layers.data_type",
    "initializer": "paddle_tpu_torch.core.initializer",
    "parameters": "paddle_tpu_torch.core.parameters",
    "trainer": "paddle_tpu_torch.trainer",
    "event": "paddle_tpu_torch.trainer.event",
    "inference": "paddle_tpu_torch.trainer.inference",
    "optimizer": "paddle_tpu_torch.optimizer",
    "reader": "paddle_tpu_torch.reader",
    "models": "paddle_tpu_torch.models",
}


def batch(reader, batch_size: int, drop_last: bool = False):
    """``paddle.batch``: group a sample reader into a batch reader."""
    from paddle_tpu_torch.reader.decorator import batch as _batch

    return _batch(reader, batch_size, drop_last)


def infer(output_layer, parameters, input, feeding=None, field="value",
          device=None):
    """``paddle.infer``: a test-mode forward of ``output_layer`` over the
    samples of ``input``, on ``cuda:0`` unless ``device`` says otherwise
    (reference: ``python/paddle/v2/inference.py:10``)."""
    from paddle_tpu_torch.trainer import inference as _inf

    return _inf.infer(output_layer=output_layer, parameters=parameters,
                      input=input, feeding=feeding, field=field,
                      device=device)


def __getattr__(name):
    target = _API_MAP.get(name)
    if target is not None:
        mod = _importlib.import_module(target)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module 'paddle_tpu_torch' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_API_MAP))
