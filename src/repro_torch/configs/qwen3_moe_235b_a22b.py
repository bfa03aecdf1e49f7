"""Architecture config (same dimensions as the reference's copy)."""
from repro_torch.configs.base import ArchConfig


# 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B scaled per assignment]
CONFIG_QWEN3_MOE_235B_A22B = ArchConfig(
    name="qwen3-moe-235b-a22b", n_layers=94, d_model=4096,
    vocab=151936, pattern=("moe",), n_heads=64, n_kv_heads=4, head_dim=128,
    qk_norm=True, n_experts=128, top_k=8, n_shared=0, moe_ff=1536, d_ff=1536,
    rope_theta=1e6, expert_chunks=8)
qwen3_moe_235b_a22b = CONFIG_QWEN3_MOE_235B_A22B
