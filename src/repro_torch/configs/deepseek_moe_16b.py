"""Architecture config (same dimensions as the reference's copy)."""
from repro_torch.configs.base import ArchConfig


# 2 shared + 64 routed top-6, fine-grained [arXiv:2401.06066]
CONFIG_DEEPSEEK_MOE_16B = ArchConfig(
    name="deepseek-moe-16b", n_layers=28, d_model=2048,
    vocab=102400, pattern=("moe",), n_heads=16, n_kv_heads=16, head_dim=128,
    n_experts=64, top_k=6, n_shared=2, moe_ff=1408, d_ff=1408,
    expert_chunks=4)
deepseek_moe_16b = CONFIG_DEEPSEEK_MOE_16B
