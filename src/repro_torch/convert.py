"""State carry-over between the JAX package and the port.

`from_numpy(tree, device)` turns a JAX state (a `Store`, a workload's
state `KVState`, `RLState`, `PCState`, `SimState` or `ServeState`, the
elastic engines' `ElasticState` and `ChurnSchedule`, a cross-pod
`BankSyncState` or `EFState`, or any of their sub-tuples, with its
leaves as numpy arrays) into the port's NamedTuple of the same name,
field for field.
`to_numpy(tree)` is the inverse: the port's tree with numpy leaves.  The
packed metadata planes are `uint32` in the JAX package and int32 bit
patterns in the port; both directions reinterpret them bit for bit.  Bool
planes (the `REPRO_NO_PACK=1` layout) are bool in both.  `leaves(tree)` flattens
a tree of either package in field order, as `jax.tree.leaves` does.

For the language models: `lm_params_to_torch(tree, device, dtype)` turns
the JAX package's parameter tree (numpy leaves, bfloat16 ones included)
into the port's, and `numpy_lm_params(cfg, seed)` draws a parameter tree
of the same layout and distributions with numpy, so that a process
without JAX (the card) and one with JAX (the golden writer, the tests)
can start from the same weights.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import costmodel, protocol, sfifo, tables
from repro_torch.distributed import compress, hier_sync
from repro_torch.kernels import common
from repro_torch.obs import trace
from repro_torch.traffic import driver
from repro_torch.workloads import harness, kv_directory, kv_serving, \
    producer_consumer, reader_lock, worksteal

TYPES = {t.__name__: t for t in (
    protocol.Store, protocol.Lease, sfifo.SFifo, tables.LRTbl, tables.PATbl,
    costmodel.Counters, trace.TraceLog, kv_directory.KVState,
    reader_lock.RLState, producer_consumer.PCState, worksteal.SimState,
    kv_serving.ServeState, driver.AgentStreams, harness.ElasticState,
    harness.ChurnSchedule, hier_sync.BankSyncState, compress.EFState)}
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
        if name in PLANES and x.dtype == np.uint32:
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
        out.append(x.view(np.uint32) if name in PLANES
                   and x.dtype == np.int32 else x)
    return type(tree)(*out)


def leaves(tree) -> list:
    """Leaves of a NamedTuple tree in field order."""
    if _is_tuple(tree):
        return [leaf for x in tree for leaf in leaves(x)]
    return [tree]


# leaves that stay float32 whatever the model's type (lm_init's norms and
# the router), as in the JAX package
F32_LEAVES = ("norm1", "norm2", "final_norm", "router")


def lm_params_to_torch(tree: dict, device=None,
                       dtype: torch.dtype = torch.float32) -> dict:
    """The JAX package's LM parameter tree (numpy leaves) -> the port's:
    the same nested dicts, leaves as `dtype` tensors on `device` (`cuda`
    unless named, as `common.resolve_device` decides) except the
    `F32_LEAVES`, which stay float32."""
    device = common.resolve_device(device)
    out = {}
    for name, x in tree.items():
        if isinstance(x, dict):
            out[name] = lm_params_to_torch(x, device, dtype)
            continue
        t = torch.from_numpy(np.asarray(x, np.float32).copy())
        out[name] = t.to(device=device, dtype=torch.float32
                         if name in F32_LEAVES else dtype)
    return out


def numpy_lm_params(cfg: ModelConfig, seed: int = 0) -> dict:
    """A float32 LM parameter tree drawn with `np.random.default_rng(seed)`
    in `repro.models.transformer.lm_init`'s layout and distributions:
    embeddings normal * 0.02, dense and expert weights uniform in
    +-sqrt(1/d_in), norms ones.  Leaves are drawn whole, stacked layers
    at once, in the order written here.

    With `cfg.qkv_bias` the attention's `bias_q`, `bias_k` and `bias_v`
    are drawn too, after `wo`, uniform in +-sqrt(1/d_model): nonzero,
    unlike `lm_init`'s zeros, so that a comparison on these weights
    would catch a bias left out."""
    rng = np.random.default_rng(seed)
    d, hd = cfg.d_model, cfg.hd
    h, hkv = cfg.n_heads, cfg.n_kv_heads

    def uni(shape, d_in):
        s = np.float32((1.0 / d_in) ** 0.5)
        return rng.random(shape, dtype=np.float32) * (2 * s) - s

    def block(n, kind):
        p = {"norm1": np.ones((n, d), np.float32),
             "attn": {"wq": uni((n, d, h * hd), d),
                      "wk": uni((n, d, hkv * hd), d),
                      "wv": uni((n, d, hkv * hd), d),
                      "wo": uni((n, h * hd, d), h * hd)},
             "norm2": np.ones((n, d), np.float32)}
        if cfg.qkv_bias:
            p["attn"].update(bias_q=uni((n, h * hd), d),
                             bias_k=uni((n, hkv * hd), d),
                             bias_v=uni((n, hkv * hd), d))
        if kind == "moe":
            m = cfg.moe
            e, f = m.n_experts, m.d_expert
            p["ffn"] = {"router": uni((n, d, e), d),
                        "experts_w1": uni((n, e, d, f), d),
                        "experts_w3": uni((n, e, d, f), d),
                        "experts_w2": uni((n, e, f, d), f)}
        else:
            p["ffn"] = {"w1": uni((n, d, cfg.d_ff), d),
                        "w3": uni((n, d, cfg.d_ff), d),
                        "w2": uni((n, cfg.d_ff, d), cfg.d_ff)}
        return p

    n_dense = cfg.moe.first_k_dense if cfg.moe else 0
    params = {"emb": rng.standard_normal((cfg.vocab, d), dtype=np.float32)
              * np.float32(0.02),
              "layers": block(cfg.n_layers - n_dense,
                              "moe" if cfg.moe else "dense"),
              "final_norm": np.ones((d,), np.float32)}
    if n_dense:
        params["dense_layers"] = block(n_dense, "dense")
    if not cfg.tie_embeddings:
        params["head"] = uni((d, cfg.vocab), d)
    return params
