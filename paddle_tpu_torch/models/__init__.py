"""Models of the port: the transformer LM (serving and training), the
ResNet image classifier, the OCR CRNN and the attention NMT.  ``image``,
``ocr_crnn`` and ``seqtoseq`` load on first access, so the serving import does not pull in the layer
API."""

import importlib as _importlib


def __getattr__(name):
    if name in ("image", "ocr_crnn", "seqtoseq"):
        return _importlib.import_module(f"paddle_tpu_torch.models.{name}")
    raise AttributeError(f"module 'paddle_tpu_torch.models' has no "
                         f"attribute {name!r}")
