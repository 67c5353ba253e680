"""Containers for tensors: frozen dataclasses whose fields are leaves.

A container is a plain `@dataclass(frozen=True)`; fields hold
`torch.Tensor`s, nested containers, dicts of tensors, or None.
`replace` builds a modified copy, `to_device` moves every tensor of a
container (recursively) to a device and, optionally, casts the floating
tensors to one dtype (index tensors keep their integer type); `to_host`
fetches a dict of tensors in one copy per dtype, and `upload` moves host
arrays to a device in one copy.
"""

import dataclasses
from typing import List

import numpy as np
import torch


def tensor_dataclass(cls):
    """Frozen dataclass with `.to(device, dtype=None)` and `.replace`."""
    cls = dataclasses.dataclass(frozen=True)(cls)

    def to(self, device, dtype=None):
        return to_device(self, device, dtype)

    def _replace(self, **kwargs):
        return dataclasses.replace(self, **kwargs)

    cls.to = to
    cls.replace = _replace
    return cls


def replace(obj, **kwargs):
    return dataclasses.replace(obj, **kwargs)


def to_host(fields):
    """{name: tensor or other} -> the same dict with every tensor fetched
    to numpy, the tensors of one dtype in ONE device-to-host copy (one
    synchronisation); other values pass through."""
    out = dict(fields)
    by_dtype = {}
    for k, v in fields.items():
        if isinstance(v, torch.Tensor):
            by_dtype.setdefault(v.dtype, []).append(k)
    for names in by_dtype.values():
        flat = torch.cat([fields[k].reshape(-1) for k in names]).cpu()
        at = 0
        for k in names:
            n = fields[k].numel()
            out[k] = flat[at:at + n].numpy().reshape(tuple(fields[k].shape))
            at += n
    return out


def upload(arrays: List[np.ndarray], dtype, device) -> List[torch.Tensor]:
    """The host arrays cast to dtype on the host (the JAX runner's
    `jnp.asarray(v, d)`), moved to device in ONE copy (pinned and
    asynchronous to a card); returns a view of each."""
    npdt = torch.empty((), dtype=dtype).numpy().dtype
    flat = np.concatenate([np.asarray(a, np.float64).ravel()
                           for a in arrays]).astype(npdt)
    buf = torch.from_numpy(flat)
    if torch.device(device).type == "cuda":
        buf = buf.pin_memory().to(device, non_blocking=True)
    out, at = [], 0
    for a in arrays:
        n = int(np.prod(np.shape(a)))
        out.append(buf[at:at + n].view(np.shape(a)))
        at += n
    return out


def to_device(obj, device, dtype=None):
    """Move every tensor inside `obj` to `device`; floating tensors are
    cast to `dtype` when given."""
    if isinstance(obj, torch.Tensor):
        if dtype is not None and obj.is_floating_point():
            return obj.to(device=device, dtype=dtype)
        return obj.to(device=device)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), device, dtype)
            for f in dataclasses.fields(obj)})
    if isinstance(obj, dict):
        return {k: to_device(v, device, dtype) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_device(v, device, dtype) for v in obj)
    return obj

