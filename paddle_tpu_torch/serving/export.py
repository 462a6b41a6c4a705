"""Read a servable — the frozen serving artifact the JAX package's
``serving/export.py`` writes: ``params.npz`` plus a ``servable.json``
manifest carrying the model config, a sha256 per payload file and the
payload inventory {param name: dtype}.  A torn or tampered artifact is
refused at load, never served; an untouched one serves on the card as
exported::

    cfg, params = load_servable(dir)            # engine input

Float params come back in the config's dtype: a servable with float32
params under a ``bfloat16`` config (what ``checkpoint_to_servable``
writes for a model trained in bf16) serves in bf16.  A servable whose
payload holds bfloat16 arrays is refused (see :func:`load_servable`).
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
    # the JAX package's export of bfloat16 params (np.savez of
    # ml_dtypes.bfloat16) stores raw 2-byte voids, which its own
    # load_servable refuses too; a bf16 servable is f32 params under a
    # bfloat16 config
    void = sorted(k for k, v in flat.items() if v.dtype.kind == "V")
    enforce(not void,
            f"servable {path}: params {void[:4]} are raw voids (|V2), as "
            "the JAX package's export_servable writes bfloat16 params "
            "(np.savez of ml_dtypes.bfloat16); its own load_servable "
            "cannot read them either. Export float32 params under a "
            "bfloat16 config (checkpoint_to_servable's output) to serve "
            "in bfloat16")
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
