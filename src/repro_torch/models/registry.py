"""Architecture registry: config name -> `Model` bundle
(`repro.models.registry`).  The port builds the dense and MoE families;
the other families are not ported yet (ROADMAP Queue A 16)."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig, unsupported
from repro_torch.kernels import common
from repro_torch.models import transformer as T

# the architectures whose configs the port has
_MODULES = {"granite-moe-1b-a400m": "granite_moe_1b",
            "qwen2.5-32b": "qwen2_5_32b",
            "qwen1.5-32b": "qwen1_5_32b",
            "mistral-large-123b": "mistral_large_123b"}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable            # (seed, device) -> params
    loss: Callable            # (params, batch) -> (loss, metrics)
    prefill: Callable         # (params, batch) -> (last_logits, caches)
    decode_step: Callable     # (params, caches, tokens, kv_len) -> (logits, caches)
    init_cache: Callable      # (b, max_len, device) -> caches
    grow_cache: Callable      # (caches, max_len) -> caches padded on S


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise NotImplementedError(
            f"{arch}: config not ported yet (ROADMAP Queue A 16); the port "
            f"has {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.SMOKE if smoke else mod.CONFIG


def build(cfg: ModelConfig) -> Model:
    unsupported(cfg)
    return Model(
        cfg=cfg,
        init=lambda seed, device=None: T.lm_init(
            torch.Generator(common.resolve_device(device)).manual_seed(seed),
            cfg),
        loss=lambda p, b, **kw: T.lm_loss(p, cfg, b, **kw),
        prefill=lambda p, b, **kw: T.lm_prefill(p, cfg, b, **kw),
        decode_step=lambda p, c, t, kl, **kw: T.lm_decode_step(
            p, cfg, c, t, kl, **kw),
        init_cache=lambda b, ml, device=None: T.lm_init_cache(cfg, b, ml,
                                                             device),
        grow_cache=lambda c, ml: T.lm_grow_cache(cfg, c, ml),
    )
