"""Models of the port: the transformer LM (serving) and the ResNet image
classifier (training).  ``image`` loads on first access, so the serving
import does not pull in the layer API."""

import importlib as _importlib


def __getattr__(name):
    if name == "image":
        return _importlib.import_module("paddle_tpu_torch.models.image")
    raise AttributeError(f"module 'paddle_tpu_torch.models' has no "
                         f"attribute {name!r}")
