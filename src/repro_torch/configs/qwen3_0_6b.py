"""Architecture config (same dimensions as the reference's copy)."""
from repro_torch.configs.base import ArchConfig


# qk_norm, GQA [hf:Qwen/Qwen3-0.6B]
CONFIG_QWEN3_0_6B = ArchConfig(
    name="qwen3-0.6b", n_layers=28, d_model=1024, vocab=151936, n_heads=16,
    n_kv_heads=8, head_dim=128, qk_norm=True, d_ff=3072, rope_theta=1e6)
qwen3_0_6b = CONFIG_QWEN3_0_6B
