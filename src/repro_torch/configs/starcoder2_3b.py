"""Architecture config (same dimensions as the reference's copy)."""
from repro_torch.configs.base import ArchConfig


# GQA, RoPE [arXiv:2402.19173]
CONFIG_STARCODER2_3B = ArchConfig(
    name="starcoder2-3b", n_layers=30, d_model=3072,
    vocab=49152, pattern=("attn",), n_heads=24, n_kv_heads=2, head_dim=128,
    d_ff=12288, act="gelu", rope_theta=1e6)
starcoder2_3b = CONFIG_STARCODER2_3B
