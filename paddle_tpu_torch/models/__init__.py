"""Models of the port: the transformer LM (serving and training), the
image zoo (smallnet, AlexNet, VGG, ResNet, GoogLeNet), the OCR CRNN, the
attention NMT and the Wide & Deep CTR.  ``image``, ``ocr_crnn``,
``seqtoseq`` and ``ctr`` load on first access, so the serving import does
not pull in the layer API."""

import importlib as _importlib


def __getattr__(name):
    if name in ("image", "ocr_crnn", "seqtoseq", "ctr"):
        return _importlib.import_module(f"paddle_tpu_torch.models.{name}")
    raise AttributeError(f"module 'paddle_tpu_torch.models' has no "
                         f"attribute {name!r}")
