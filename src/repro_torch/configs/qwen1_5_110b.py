"""Architecture config (same dimensions as the reference's copy)."""
from repro_torch.configs.base import ArchConfig


# QKV bias [hf:Qwen/Qwen1.5-110B]
CONFIG_QWEN1_5_110B = ArchConfig(
    name="qwen1.5-110b", n_layers=80, d_model=8192,
    vocab=152064, pattern=("attn",), n_heads=64, n_kv_heads=8, head_dim=128,
    qkv_bias=True, d_ff=49152, rope_theta=1e6)
qwen1_5_110b = CONFIG_QWEN1_5_110B
