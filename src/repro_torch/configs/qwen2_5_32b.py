"""qwen2.5-32b: dense, 64L d=5120 40H (GQA kv=8) d_ff=27648 vocab=152064,
QKV bias, RMSNorm, SwiGLU, rope theta 1e6.  [hf:Qwen/Qwen2.5 family.]
The same CONFIG and SMOKE as `repro.configs.qwen2_5_32b`."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=27648,
    vocab=152064, head_dim=128, qkv_bias=True, rope_theta=1e6,
    microbatch=64, optimizer="adamw",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=512, head_dim=16, microbatch=None, dtype="float32",
)
