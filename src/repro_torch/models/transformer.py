"""Decoder-only transformer LM, dense and MoE families
(`repro.models.transformer`): `lm_init`, the training loss `lm_loss`
(with `xent_loss` and per-layer remat), `lm_prefill` (cache +
last-token logits), `lm_decode_step` (one token against the cache),
`lm_init_cache` and `lm_grow_cache`.

The parameter tree is the JAX package's: `emb`, `layers` with every leaf
stacked on a leading layer axis, `final_norm`, `dense_layers` for
`first_k_dense` and `head` when embeddings are untied.  The layer loop
is a Python loop over that axis.  Caches are a list of (k, v) pairs
[L, B, Hkv, S, D], one per stack; `lm_decode_step` writes the new
token's K/V into them in place and returns them.  Remat "full" (the
JAX `nothing_saveable` policy) is `torch.utils.checkpoint` around each
layer; remat "dots" and multi-token prediction are not ported (ROADMAP
Queue A 16).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, unsupported
from repro_torch.kernels import common
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def stack_init(init_fn, n: int) -> dict:
    """n trees from `init_fn()`, stacked leaf by leaf on a new axis 0."""
    trees = [init_fn() for _ in range(n)]

    def stack(path_trees):
        if isinstance(path_trees[0], dict):
            return {k: stack([t[k] for t in path_trees])
                    for k in path_trees[0]}
        return torch.stack(path_trees)
    return stack(trees)


def layer(stack: dict, i: int) -> dict:
    """Layer i's parameters: every stacked leaf indexed on axis 0."""
    return tree_map(lambda x: x[i], stack)


def unstack(stack: dict) -> list:
    """Every layer's parameters, each stacked leaf unbound on axis 0 once:
    the backward stacks the layers' gradients in one operation, where
    indexing layer by layer would add a zero-padded full-size gradient
    per layer."""
    parts = tree_map(lambda x: x.unbind(0), stack)
    return [tree_map(lambda xs: xs[i], parts)
            for i in range(len(parts["norm1"]))]


# ------------------------------------------------------------------ blocks


def block_init(gen: torch.Generator, cfg: ModelConfig, kind: str) -> dict:
    """kind: 'dense' or 'moe' (the FFN type)."""
    dtype = _dtype(cfg)
    ones = torch.ones(cfg.d_model, dtype=torch.float32, device=gen.device)
    attn = A.gqa_init(gen, cfg, dtype)
    ffn = (M.moe_init(gen, cfg, dtype) if kind == "moe"
           else L.swiglu_init(gen, cfg.d_model, cfg.d_ff, dtype))
    return {"norm1": ones, "attn": attn, "norm2": ones.clone(), "ffn": ffn}


def _ffn_apply(p: dict, cfg: ModelConfig, kind: str, h2d: torch.Tensor,
               moe_groups: int | None = None) -> torch.Tensor:
    if kind == "moe":
        return M.moe_apply(p, cfg, h2d, groups=moe_groups)
    return L.swiglu_apply(p, h2d)


def block_apply(p: dict, cfg: ModelConfig, kind: str, h: torch.Tensor,
                positions: torch.Tensor):
    """Full-sequence (prefill) block: (h, the layer's (k, v) cache)."""
    b, s, d = h.shape
    a, cache = A.gqa_train(p["attn"], cfg, L.rmsnorm(h, p["norm1"]),
                           positions)
    h = h + a
    f = _ffn_apply(p["ffn"], cfg, kind,
                   L.rmsnorm(h, p["norm2"]).reshape(b * s, d))
    return h + f.reshape(b, s, d), cache


def block_train(p: dict, cfg: ModelConfig, kind: str, h: torch.Tensor,
                positions: torch.Tensor):
    """Full-sequence training block: (h, the layer's aux loss, float32;
    0 for a dense layer)."""
    b, s, d = h.shape
    a, _ = A.gqa_train(p["attn"], cfg, L.rmsnorm(h, p["norm1"]), positions,
                       return_cache=False)
    h = h + a
    hn = L.rmsnorm(h, p["norm2"]).reshape(b * s, d)
    if kind == "moe":
        f, aux, _ = M.moe_train(p["ffn"], cfg, hn)
    else:
        f = L.swiglu_apply(p["ffn"], hn)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return h + f.reshape(b, s, d), aux


def block_decode(p: dict, cfg: ModelConfig, kind: str, h: torch.Tensor,
                 cache, kv_len: torch.Tensor,
                 moe_groups: int | None = None):
    b, s, d = h.shape
    a, cache = A.gqa_decode(p["attn"], cfg, L.rmsnorm(h, p["norm1"]),
                            cache, kv_len)
    h = h + a
    f = _ffn_apply(p["ffn"], cfg, kind,
                   L.rmsnorm(h, p["norm2"]).reshape(b * s, d), moe_groups)
    return h + f.reshape(b, s, d), cache


# ------------------------------------------------------------------- model


def _stacks(params: dict, cfg: ModelConfig):
    """(stack name, FFN kind) in the order the layers run."""
    out = [("dense_layers", "dense")] if "dense_layers" in params else []
    return out + [("layers", "moe" if cfg.moe else "dense")]


def lm_init(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random parameters on `gen`'s device, drawn from `gen`."""
    unsupported(cfg)
    dtype = _dtype(cfg)
    n_dense = cfg.moe.first_k_dense if cfg.moe else 0
    main_kind = "moe" if cfg.moe else "dense"
    params = {"emb": L.embed_init(gen, cfg.vocab, cfg.d_model, dtype),
              "layers": stack_init(lambda: block_init(gen, cfg, main_kind),
                                   cfg.n_layers - n_dense),
              "final_norm": torch.ones(cfg.d_model, dtype=torch.float32,
                                       device=gen.device)}
    if n_dense:
        params["dense_layers"] = stack_init(
            lambda: block_init(gen, cfg, "dense"), n_dense)
    if not cfg.tie_embeddings:
        params["head"] = L.dense_init(gen, cfg.d_model, cfg.vocab, dtype)
    return params


def _embed(params: dict, cfg: ModelConfig, tokens: torch.Tensor):
    return params["emb"][tokens.long()].to(_dtype(cfg))


def _head(params: dict, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    w = params["emb"].T if cfg.tie_embeddings else params["head"]
    return h @ w


def _run_stack(stack: dict, cfg: ModelConfig, kind: str, h: torch.Tensor,
               positions: torch.Tensor, *, remat: bool = True):
    """The layers of `stack` in order: (h, the sum of their aux losses).
    With `remat` each layer runs under `torch.utils.checkpoint`
    (non-reentrant): its forward is recomputed in the backward, so the
    forward kernels launch twice a training step."""
    if remat and cfg.remat_policy != "full":
        raise NotImplementedError(
            f"remat policy {cfg.remat_policy!r}: only 'full' is ported "
            f"(ROADMAP Queue A 16)")
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for lp in unstack(stack):
        if remat:
            h, a = checkpoint(block_train, lp, cfg, kind, h, positions,
                              use_reentrant=False)
        else:
            h, a = block_train(lp, cfg, kind, h, positions)
        aux = aux + a
    return h, aux


def xent_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Stable cross entropy in float32, mean over positions."""
    lf = logits.float()
    m = lf.max(-1, keepdim=True).values
    lse = torch.log(torch.exp(lf - m).sum(-1)) + m[..., 0]
    gold = lf.gather(-1, labels.long()[..., None])[..., 0]
    return (lse - gold).mean()


def lm_loss(params: dict, cfg: ModelConfig, batch: dict, *,
            remat: bool = True):
    """batch {"tokens": [B, S], "labels": [B, S]} -> (loss, metrics):
    next-token cross entropy plus the MoE layers' aux loss, with metrics
    `xent`, `aux` and `loss` (0-d float32 tensors)."""
    unsupported(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    h = _embed(params, cfg, tokens)
    if "dense_layers" in params:
        h, _ = _run_stack(params["dense_layers"], cfg, "dense", h, positions,
                          remat=remat)
    h, aux = _run_stack(params["layers"], cfg, "moe" if cfg.moe else "dense",
                        h, positions, remat=remat)
    h = L.rmsnorm(h, params["final_norm"])
    xent = xent_loss(_head(params, cfg, h), batch["labels"])
    loss = xent + aux
    return loss, {"xent": xent, "aux": aux, "loss": loss}


def lm_prefill(params: dict, cfg: ModelConfig, batch: dict):
    """batch {"tokens": [B, S]} -> (last-token logits [B, V], caches)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    h = _embed(params, cfg, tokens)
    caches = []
    for name, kind in _stacks(params, cfg):
        ks, vs = [], []
        for i in range(params[name]["norm1"].shape[0]):
            h, (k, v) = block_apply(layer(params[name], i), cfg, kind, h,
                                    positions)
            ks.append(k)
            vs.append(v)
        caches.append((torch.stack(ks), torch.stack(vs)))
    h = L.rmsnorm(h, params["final_norm"])
    return _head(params, cfg, h[:, -1]), caches


def lm_grow_cache(cfg: ModelConfig, caches, max_len: int):
    """Zero-pad each (k, v) [L, B, Hkv, S, D] to S = max_len slots."""
    def pad(x):
        return torch.nn.functional.pad(x, (0, 0, 0, max_len - x.shape[3]))
    return [(pad(k), pad(v)) for k, v in caches]


def lm_init_cache(cfg: ModelConfig, b: int, max_len: int, device=None):
    """Zero decode caches: one (k, v) [L, b, Hkv, max_len, D] per stack,
    on `device` (`cuda` unless named)."""
    device = common.resolve_device(device)
    n_dense = cfg.moe.first_k_dense if cfg.moe else 0
    shape = (b, cfg.n_kv_heads, max_len, cfg.hd)
    return [(torch.zeros((n,) + shape, dtype=_dtype(cfg), device=device),
             torch.zeros((n,) + shape, dtype=_dtype(cfg), device=device))
            for n in ([n_dense] if n_dense else []) + [cfg.n_layers - n_dense]]


def lm_decode_step(params: dict, cfg: ModelConfig, caches, tokens,
                   kv_len, *, moe_groups: int | None = None):
    """tokens [B, 1]; kv_len [B] -> (logits [B, V], caches written in
    place).  `moe_groups` None dispatches the B tokens as `moe_apply`
    derives; the engine passes B, one group per slot."""
    h = _embed(params, cfg, tokens)
    for (name, kind), (kc, vc) in zip(_stacks(params, cfg), caches):
        for i in range(kc.shape[0]):
            h, _ = block_decode(layer(params[name], i), cfg, kind, h,
                                (kc[i], vc[i]), kv_len, moe_groups)
    h = L.rmsnorm(h, params["final_norm"])
    return _head(params, cfg, h[:, -1]), caches
