"""Read a servable — the frozen serving artifact the JAX package's
``serving/export.py`` writes: ``params.npz`` plus a ``servable.json``
manifest carrying the model config, a sha256 per payload file and the
payload inventory {param name: dtype}.  A torn or tampered artifact is
refused at load, never served; an untouched one serves on the card as
exported::

    cfg, params = load_servable(dir)            # engine input
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

from paddle_tpu_torch.core.dtype import from_name
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.core.place import resolve_device
from paddle_tpu_torch.models.transformer import (
    TransformerConfig,
    params_from_numpy,
)

MANIFEST = "servable.json"


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _cfg_from_json(d: dict) -> TransformerConfig:
    d = dict(d)
    d["dtype"] = from_name(d["dtype"])
    return TransformerConfig(**d)


def load_servable(path: str, device=None):
    """Validate hashes and inventory; return (TransformerConfig, params)
    with params on ``device`` (``None`` = the card)."""
    device = resolve_device(device)
    mpath = os.path.join(path, MANIFEST)
    enforce(os.path.exists(mpath), f"no servable manifest at {mpath}")
    with open(mpath) as f:
        manifest = json.load(f)
    for fname, digest in manifest["files"].items():
        fpath = os.path.join(path, fname)
        enforce(os.path.exists(fpath),
                f"servable {path}: {fname} is listed in the manifest "
                "but missing from disk — refusing a partial artifact")
        enforce(_sha256(fpath) == digest,
                f"servable {path}: {fname} hash mismatch — refusing to "
                "serve a corrupt/tampered artifact")
    cfg = _cfg_from_json(manifest["config"])
    with np.load(os.path.join(path, "params.npz")) as z:
        flat = {k: z[k] for k in z.files}
    # payload-vs-manifest inventory (manifests that predate the "params"
    # field skip it): a missing or extra param, or a dtype drift, means
    # the artifact is not what was exported
    inventory = manifest.get("params")
    if inventory is not None:
        missing = sorted(set(inventory) - set(flat))
        extra = sorted(set(flat) - set(inventory))
        enforce(not missing and not extra,
                f"servable {path}: payload params do not match the "
                f"manifest (missing {missing[:4]}, unexpected "
                f"{extra[:4]}) — refusing a partial artifact")
        drift = {k: (inventory[k], str(flat[k].dtype)) for k in inventory
                 if str(flat[k].dtype) != inventory[k]}
        enforce(not drift,
                f"servable {path}: param dtype mismatch vs manifest "
                f"{dict(list(drift.items())[:4])} — refusing to serve "
                "garbage")
    # float payloads come back at the config's dtype (npz stores
    # extension dtypes upcast, the checkpoint convention)
    return cfg, params_from_numpy(flat, device=device, dtype=cfg.dtype)
