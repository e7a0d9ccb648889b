"""Model config schema: the port's own copy of `repro.configs.base`.

`ModelConfig` and `MoECfg` carry the fields of the JAX package's
dataclasses, with the same names and defaults, so a config reads the
same in both packages.  The port builds the dense and MoE families with
GQA attention (QKV bias included); a config that needs multi-head latent attention, an SSM
or xLSTM stack, an encoder, image patches or multi-token prediction
raises `NotImplementedError` from `unsupported()` (ROADMAP Queue A 16).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0
    first_k_dense: int = 0
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    # tokens are split into this many dispatch groups (halved until it
    # divides the token count); each group packs its own expert capacity
    dispatch_groups: int = 32


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str            # dense | moe | vlm | ssm_xlstm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    partial_rotary: float = 1.0
    norm: str = "rmsnorm"   # rmsnorm | layernorm
    act: str = "swiglu"     # swiglu | gelu
    tie_embeddings: bool = False
    moe: Optional[MoECfg] = None
    mla: Optional[object] = None
    ssm: Optional[object] = None
    attn_every: int = 0
    enc_layers: int = 0
    n_patches: int = 0
    mtp_heads: int = 0
    xlstm_pattern: str = ""
    dtype: str = "bfloat16"
    microbatch: Optional[int] = None
    optimizer: str = "adamw"
    seq_parallel: bool = False
    remat_policy: str = "full"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads


def unsupported(cfg: ModelConfig) -> None:
    """Raise `NotImplementedError` when `cfg` needs a part of the model
    zoo the port does not have yet (ROADMAP Queue A 16)."""
    missing = [name for name, used in (
        ("family " + cfg.family, cfg.family not in ("dense", "moe")),
        ("multi-head latent attention", cfg.mla is not None),
        ("SSM layers", cfg.ssm is not None),
        ("an encoder", cfg.enc_layers > 0),
        ("image patches", cfg.n_patches > 0),
        ("multi-token prediction", cfg.mtp_heads > 0),
        ("layernorm", cfg.norm != "rmsnorm"),
        ("the gelu MLP", cfg.act != "swiglu"),
        ("shared experts", cfg.moe is not None and cfg.moe.n_shared > 0),
    ) if used]
    if missing:
        raise NotImplementedError(
            f"{cfg.name} needs {', '.join(missing)}: not ported yet "
            f"(ROADMAP Queue A 16)")
