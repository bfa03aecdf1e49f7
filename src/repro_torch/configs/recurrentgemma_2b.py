"""Architecture config (same dimensions as the reference's copy)."""
from repro_torch.configs.base import ArchConfig


# --- hybrid -----------------------------------------------------------------
# RG-LRU + local attention, 1 attn : 2 recurrent [arXiv:2402.19427]
CONFIG_RECURRENTGEMMA_2B = ArchConfig(
    name="recurrentgemma-2b", n_layers=26, d_model=2560,
    vocab=256000, pattern=("rec", "rec", "local"), n_heads=10, n_kv_heads=1,
    head_dim=256, d_ff=7680, act="gelu", window=2048, rnn_width=2560,
    conv_width=4, long_context=True)
recurrentgemma_2b = CONFIG_RECURRENTGEMMA_2B
