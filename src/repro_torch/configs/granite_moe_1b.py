"""granite-moe-1b-a400m: MoE, 24L d=1024 16H (GQA kv=8) d_expert=512
vocab=49155, 32 experts top-8.  [hf:ibm-granite/granite-3.0-1b-a400m-base.]
The same CONFIG and SMOKE as `repro.configs.granite_moe_1b`."""
import dataclasses

from repro_torch.configs.base import ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, d_ff=512,
    vocab=49155, head_dim=64, tie_embeddings=True,
    moe=MoECfg(n_experts=32, top_k=8, d_expert=512),
    microbatch=64, optimizer="adamw",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=64,
    vocab=512, head_dim=16,
    moe=MoECfg(n_experts=4, top_k=2, d_expert=64), dtype="float32",
)
