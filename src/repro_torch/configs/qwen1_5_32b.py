"""qwen1.5-32b: dense MHA (kv=40), 64L d=5120 40H d_ff=27392
vocab=152064, QKV bias.  [hf:Qwen/Qwen1.5 family.]
The same CONFIG and SMOKE as `repro.configs.qwen1_5_32b`."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40, d_ff=27392,
    vocab=152064, head_dim=128, qkv_bias=True, rope_theta=1e6,
    microbatch=64, optimizer="adamw",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab=512, head_dim=16, microbatch=None, dtype="float32",
)
