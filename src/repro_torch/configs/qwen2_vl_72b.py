"""Architecture config (same dimensions as the reference's copy)."""
from repro_torch.configs.base import ArchConfig


# M-RoPE, dynamic resolution [arXiv:2409.12191]; the backbone only: patch
# embeddings and (t, h, w) positions come from the input stub
CONFIG_QWEN2_VL_72B = ArchConfig(
    name="qwen2-vl-72b", n_layers=80, d_model=8192,
    vocab=152064, pattern=("attn",), n_heads=64, n_kv_heads=8, head_dim=128,
    qkv_bias=True, mrope=True, d_ff=29568, rope_theta=1e6,
    embed_inputs=True)
qwen2_vl_72b = CONFIG_QWEN2_VL_72B
