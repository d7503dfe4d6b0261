"""Model persistence: the port of ``tpu_sgd/utils/persistence.py``.

The same directory format as the JAX package, so a model saved by either
package loads in the other: ``metadata.json`` (class name, format
version, numFeatures, intercept, threshold, a per-save id, and for a
multinomial model numClasses and hasInterceptColumn, written in that key
order by ``json.dumps``) beside ``data.npz`` (the weights as a float32
array and the same save id).  Each file is written to a temporary name,
fsynced and renamed; the shared save id turns a crash between the two
renames into a clear error at load.
"""

from __future__ import annotations

import glob
import inspect
import json
import os
import uuid
from typing import Optional

import numpy as np
import torch

FORMAT_VERSION = "1.0"


def save_glm_model(path: str, model) -> None:
    """Persist a GLM model directory: ``metadata.json`` + ``data.npz``."""
    os.makedirs(path, exist_ok=True)
    for stale in glob.glob(os.path.join(path, ".*.tmp")):
        try:  # a crash mid-save orphaned these; sweep before writing
            os.remove(stale)
        except OSError:
            pass
    w = model.weights
    weights = (w.detach().cpu().numpy() if isinstance(w, torch.Tensor)
               else np.asarray(w))
    save_id = uuid.uuid4().hex
    meta = {
        "class": type(model).__name__,
        "version": FORMAT_VERSION,
        "numFeatures": int(getattr(model, "num_features", weights.shape[-1])),
        "intercept": float(model.intercept),
        "threshold": getattr(model, "threshold", None),
        "saveId": save_id,
    }
    if hasattr(model, "num_classes"):
        meta["numClasses"] = int(model.num_classes)
        meta["hasInterceptColumn"] = bool(
            getattr(model, "has_intercept_column", False)
        )

    def _durable_write(name, writer):
        final = os.path.join(path, name)
        tmp = os.path.join(path, "." + name + ".tmp")
        with open(tmp, "wb") as f:
            writer(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)

    _durable_write(
        "data.npz",
        lambda f: np.savez(f, weights=weights, save_id=np.asarray(save_id)),
    )
    _durable_write(
        "metadata.json", lambda f: f.write(json.dumps(meta).encode())
    )


def load_glm_model(path: str, cls, strict_class: bool = True, device=None):
    """Load a model saved by :func:`save_glm_model` (by either package) as
    an instance of ``cls`` with its weights on ``device`` (``None``: the
    card); validates the class name and the format version."""
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    if meta["version"] != FORMAT_VERSION:
        raise ValueError(f"unsupported model format version {meta['version']}")
    if strict_class and meta["class"] != cls.__name__:
        raise ValueError(
            f"model at {path} is a {meta['class']}, expected {cls.__name__}"
        )
    data = np.load(os.path.join(path, "data.npz"))
    if "save_id" in data.files and "saveId" in meta:
        if str(data["save_id"]) != meta["saveId"]:
            raise ValueError(
                f"model directory {path!r} is torn: metadata.json and "
                "data.npz come from different saves (a crash interrupted "
                "an overwrite) — re-save the model"
            )
    accepts_classes = "num_classes" in inspect.signature(cls.__init__).parameters
    if "numClasses" in meta and accepts_classes:
        model = cls(
            data["weights"],
            meta["intercept"],
            num_classes=meta["numClasses"],
            num_features=meta["numFeatures"],
            has_intercept_column=meta.get("hasInterceptColumn", False),
            device=device,
        )
    else:
        model = cls(data["weights"], meta["intercept"], device=device)
    thr: Optional[float] = meta.get("threshold")
    if hasattr(model, "threshold"):
        model.threshold = thr
    return model
