"""Architecture config (same dimensions as the reference's copy)."""
from repro_torch.configs.base import ArchConfig


# 5:1 local:global, head dim 256, gelu [hf:google/gemma-3-4b]
CONFIG_GEMMA3_4B = ArchConfig(
    name="gemma3-4b", n_layers=34, d_model=2560,
    vocab=262144, pattern=("local",) * 5 + ("attn",), n_heads=8,
    n_kv_heads=4, head_dim=256, qk_norm=True, d_ff=10240, act="gelu",
    window=1024, rope_theta=1e6)
gemma3_4b = CONFIG_GEMMA3_4B
