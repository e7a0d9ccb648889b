"""State carry-over between the JAX package and the port.

`from_numpy(tree, device)` turns a JAX state (a `Store`, `KVState` or any
of their sub-tuples, with its leaves as numpy arrays) into the port's
NamedTuple of the same name, field for field.  `to_numpy(tree)` is the
inverse: the port's tree with numpy leaves.  The packed metadata planes
are `uint32` in the JAX package and int32 bit patterns in the port;
both directions reinterpret them bit for bit.  `leaves(tree)` flattens
a tree of either package in field order, as `jax.tree.leaves` does.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import costmodel, protocol, sfifo, tables
from repro_torch.obs import trace
from repro_torch.workloads import kv_directory

TYPES = {t.__name__: t for t in (
    protocol.Store, protocol.Lease, sfifo.SFifo, tables.LRTbl, tables.PATbl,
    costmodel.Counters, trace.TraceLog, kv_directory.KVState)}
PLANES = ("wvalid", "wdirty")   # uint32 in JAX, int32 bit patterns here


def _is_tuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def from_numpy(tree, device=None):
    """JAX state with numpy leaves -> the port's state on `device`."""
    port = TYPES[type(tree).__name__]
    out = []
    for name, x in zip(tree._fields, tree):
        if _is_tuple(x):
            out.append(from_numpy(x, device))
            continue
        x = np.asarray(x)
        if name in PLANES:
            x = x.view(np.int32)
        out.append(torch.as_tensor(x.copy(), device=device))
    return port(*out)


def to_numpy(tree):
    """The port's state -> the same NamedTuples with numpy leaves
    (planes as uint32, the JAX layout)."""
    out = []
    for name, x in zip(tree._fields, tree):
        if _is_tuple(x):
            out.append(to_numpy(x))
            continue
        x = x.detach().cpu().numpy()
        out.append(x.view(np.uint32) if name in PLANES else x)
    return type(tree)(*out)


def leaves(tree) -> list:
    """Leaves of a NamedTuple tree in field order."""
    if _is_tuple(tree):
        return [leaf for x in tree for leaf in leaves(x)]
    return [tree]
