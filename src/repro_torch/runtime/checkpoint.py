"""Checkpoints (`repro.runtime.checkpoint`): one `.npy` per leaf, a JSON
manifest, an atomic rename of `.tmp_step_N` into `step_%08d`, an
optional save on a background thread, and garbage collection that keeps
the newest `keep`.

The format and the leaf paths are the JAX package's, so a checkpoint
written by either package restores in the other, leaf for leaf.  A
tree is nested dicts (keys sorted), NamedTuples (a field's path
component is `.name`), lists and tuples (the index), with tensors,
numpy arrays or Python scalars at the leaves; None is an empty subtree.
`{'b': A(x, y=[u, v]), 'a': w}` has the paths `a`, `b/.x`, `b/.y/0`,
`b/.y/1`, as `jax.tree_util.tree_flatten_with_path` spells them.

Leaf types follow `repro_torch.convert`: the packed metadata planes
(`wvalid`, `wdirty`) are int32 bit patterns here and uint32 in the JAX
package, so they are written as uint32 and read back into an int32 leaf
bit for bit.  numpy has no bfloat16: a bfloat16 leaf (a model's
weights in training) is written as float32, exactly, and read back into
a bfloat16 `like` leaf as bfloat16.  Restored leaves are tensors, on the
device of the `like` leaf where that is a tensor, else on the CPU.  Resharding on restore is
not ported (one card has no mesh).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.convert import PLANES


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, prefix=()) -> list:
    """[(path components, leaf)] in the JAX package's leaf order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], prefix + (str(k),))]
    if _is_namedtuple(tree):
        return [kv for f, x in zip(tree._fields, tree)
                for kv in _flatten(x, prefix + (f".{f}",))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, x in enumerate(tree)
                for kv in _flatten(x, prefix + (str(i),))]
    return [(prefix, tree)]


def _unflatten(like, leaves):
    """`like`'s structure with its leaves taken in order from `leaves`."""
    if like is None:
        return None
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(x, leaves) for x in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(x, leaves) for x in like)
    return next(leaves)


def _host(path: tuple, leaf) -> np.ndarray:
    """A leaf as the numpy array the JAX package would save."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        arr = (leaf.float() if leaf.dtype == torch.bfloat16
               else leaf).cpu().numpy()
    else:
        arr = np.asarray(leaf)
    if path and path[-1].lstrip(".") in PLANES and arr.dtype == np.int32:
        arr = arr.view(np.uint32)
    return arr


def save_checkpoint(ckpt_dir: str, step: int, state: Any, *,
                    async_save: bool = False,
                    keep: int = 3) -> Optional[threading.Thread]:
    """Write `state` (any tree) as `step_<step>` under `ckpt_dir`; the
    leaves are copied to the host before the call returns.  With
    `async_save` the files are written on a thread, which is returned."""
    host = [("/".join(p), _host(p, x)) for p, x in _flatten(state)]

    def write():
        tmp = os.path.join(ckpt_dir, f".tmp_step_{step}")
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "time": time.time(), "leaves": []}
        for i, (path, arr) in enumerate(host):
            np.save(os.path.join(tmp, f"{i}.npy"), arr)
            manifest["leaves"].append(
                {"i": i, "path": path, "shape": list(arr.shape),
                 "dtype": str(arr.dtype)})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _gc(ckpt_dir, keep)

    if async_save:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    write()
    return None


def _steps(ckpt_dir: str) -> list:
    return sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))


def _gc(ckpt_dir: str, keep: int) -> None:
    for d in _steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    return os.path.join(ckpt_dir, steps[-1]) if steps else None


def _leaf(arr: np.ndarray, like) -> torch.Tensor:
    """A saved array as a tensor beside `like`: an int32 `like` takes a
    uint32 array's bits (a packed plane written by the JAX package)."""
    dev = like.device if isinstance(like, torch.Tensor) else "cpu"
    if isinstance(like, torch.Tensor) and like.dtype == torch.int32 \
            and arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    t = torch.as_tensor(arr, device=dev)
    if isinstance(like, torch.Tensor) and like.dtype == torch.bfloat16:
        t = t.to(torch.bfloat16)
    return t


def restore_checkpoint(path: str, like: Any, *, shardings: Any = None):
    """(step, tree): the checkpoint at `path` in the structure of
    `like`."""
    if shardings is not None:
        raise NotImplementedError(
            "restoring onto shardings (reshard on restore, "
            "runtime/elastic.py) is not ported: ROADMAP Queue A 15")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {rec["path"]: rec for rec in manifest["leaves"]}
    leaves = []
    for p, x in _flatten(like):
        rec = by_path.get("/".join(p))
        if rec is None:
            raise KeyError(f"checkpoint missing leaf {'/'.join(p)!r}")
        leaves.append(_leaf(np.load(os.path.join(path, f"{rec['i']}.npy")),
                            x))
    return manifest["step"], _unflatten(like, iter(leaves))
