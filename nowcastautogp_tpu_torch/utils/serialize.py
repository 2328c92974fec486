"""Checkpoint / resume: persist fitted ensembles to disk.

Port of the JAX package's ``utils/serialize.py``.  A model's dict state
persists as an ``.npz`` archive with a JSON header -- dependency-free, no
pickle execution on load -- in the JAX package's layout: the same header
(``scalars``, ``config``, ``rng_state``, ``ds_kind``) and array names,
``key`` included, plus the port's own fields (the header's ``device`` and
the ``generator_state`` array).  Checkpoints load across the two packages:

* a JAX package checkpoint has no ``generator_state``; the port maps its
  ``key`` to a torch generator as ``GPModel.from_jax_state`` does;
* a port checkpoint carries a valid threefry ``key`` (``[0, seed]``, the
  key data of ``PRNGKey(seed)``) whose 32-bit seed is derived from the
  torch generator's state, so the JAX package's ``load_model`` reads it;
  it ignores the port's extra fields.
"""

from __future__ import annotations

import hashlib
import io
import json

import numpy as np
import torch

from ..models.config import GPConfig
from ..models.gp_model import (
    GPModel, _seeded_generator, key_seed, threefry_key_data,
)

__all__ = ["save_model", "load_model"]

_ARRAY_KEYS = ("y", "order", "node_types", "params", "log_noise", "lml",
               "log_weight", "hmc_eps_scale", "key")
_SCALAR_KEYS = ("version", "n_ingested", "t0", "t_scale", "y_mean", "y_std")


def _state_seed(generator_state: np.ndarray) -> int:
    """A 32-bit seed drawn from a torch generator's state bytes."""
    digest = hashlib.sha256(np.ascontiguousarray(generator_state).tobytes())
    return int.from_bytes(digest.digest()[:4], "little")


def save_model(model: GPModel, path: str) -> None:
    """Serialize a model (``model.to_dict()`` state) to an ``.npz`` file."""
    d = model.to_dict()
    cfg = d["config"]
    header = {
        "scalars": {k: d[k] for k in _SCALAR_KEYS},
        "config": {
            "node_dist_leaf": list(cfg.node_dist_leaf),
            "node_dist_nocp": list(cfg.node_dist_nocp),
            "node_dist_cp": list(cfg.node_dist_cp),
            "changepoints": cfg.changepoints,
            "max_depth": cfg.max_depth,
            "noise": cfg.noise,
            "prior": cfg.prior,
        },
        "rng_state": _jsonify(d["rng_state"]),
        "ds_kind": "datetime64" if getattr(d["ds"], "dtype", None) is not None
                   and d["ds"].dtype.kind == "M" else "object",
        "device": d["device"],
    }
    d["key"] = threefry_key_data(_state_seed(d["generator_state"]))
    arrays = {k: np.asarray(d[k]) for k in _ARRAY_KEYS}
    arrays["generator_state"] = np.asarray(d["generator_state"])
    # dates: store as int64 datetime64[ns] when possible, else float days
    ds = d["ds"]
    try:
        arrays["ds"] = np.asarray(ds, dtype="datetime64[ns]").astype(np.int64)
        header["ds_kind"] = "datetime64_ns"
    except Exception:
        from .dates import dates_to_float

        arrays["ds"] = dates_to_float(ds)
        header["ds_kind"] = "float_days"
    buf = io.BytesIO()
    np.savez_compressed(buf, header=np.frombuffer(
        json.dumps(header).encode(), dtype=np.uint8), **arrays)
    with open(path, "wb") as f:
        f.write(buf.getvalue())


def load_model(path: str, device=None) -> GPModel:
    """Reconstruct a model saved with :func:`save_model` by either package.

    ``device``: where the model lives; by default the device a port
    checkpoint was saved from, and the card for a JAX package checkpoint.
    A torch generator state moves only between devices of one type; across
    types the generator is seeded from a hash of the saved state.
    """
    with np.load(path) as z:
        header = json.loads(bytes(z["header"]).decode())
        # hmc_eps_scale absent in old JAX package checkpoints: GPModel
        # defaults the missing key to ones on load
        arrays = {k: z[k] for k in _ARRAY_KEYS if k in z}
        gen_state = z["generator_state"] if "generator_state" in z else None
        ds_raw = z["ds"]
    cfg_h = header["config"]
    config = GPConfig(
        node_dist_leaf=cfg_h["node_dist_leaf"],
        node_dist_nocp=cfg_h["node_dist_nocp"],
        node_dist_cp=cfg_h["node_dist_cp"],
        changepoints=cfg_h["changepoints"],
        max_depth=cfg_h["max_depth"],
        noise=cfg_h["noise"],
        prior=cfg_h["prior"],
    )
    if header["ds_kind"] == "datetime64_ns":
        ds = np.asarray(ds_raw, dtype=np.int64).view("datetime64[ns]")
    else:
        ds = np.asarray(ds_raw, dtype=np.float64)
    d = dict(header["scalars"])
    d.update(arrays)
    d["ds"] = ds
    d["config"] = config
    d["rng_state"] = _unjsonify(header["rng_state"])
    if gen_state is None:  # a JAX package checkpoint
        return GPModel.from_jax_state(
            d, device="cuda" if device is None else device)
    saved = torch.device(header["device"])
    dev = saved if device is None else torch.device(device)
    d.pop("key", None)
    d["device"] = str(dev)
    if dev.type == saved.type:
        d["generator_state"] = gen_state
    else:
        d["generator_state"] = _seeded_generator(
            dev, key_seed(threefry_key_data(_state_seed(gen_state)))
        ).get_state().numpy()
    return GPModel(d)


def _jsonify(obj):
    """numpy-state dicts -> JSON-safe structures."""
    if isinstance(obj, dict):
        return {k: _jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, np.ndarray):
        return {"__ndarray__": obj.tolist(), "dtype": str(obj.dtype)}
    return obj


def _unjsonify(obj):
    if isinstance(obj, dict):
        if "__ndarray__" in obj:
            return np.asarray(obj["__ndarray__"], dtype=obj["dtype"])
        return {k: _unjsonify(v) for k, v in obj.items()}
    return obj
