"""Architecture config (same dimensions as the reference's copy)."""
from repro_torch.configs.base import ArchConfig


# decoder-only over EnCodec tokens [arXiv:2306.05284]; the backbone only:
# frame embeddings come from the input stub
CONFIG_MUSICGEN_LARGE = ArchConfig(
    name="musicgen-large", n_layers=48, d_model=2048,
    vocab=2048, pattern=("attn",), n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, embed_inputs=True)
musicgen_large = CONFIG_MUSICGEN_LARGE
