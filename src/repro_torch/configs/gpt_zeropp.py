"""The paper's own GPT-style configs (same dimensions as the reference's)."""
from repro_torch.configs.base import ArchConfig


# paper §5.4 convergence model
CONFIG_GPT_350M = ArchConfig(
    name="gpt-350m", n_layers=24, d_model=1024, vocab=50304, n_heads=16,
    n_kv_heads=16, head_dim=64, d_ff=4096)
gpt_350m = CONFIG_GPT_350M

# paper §5.2 scalability model
CONFIG_GPT_18B = ArchConfig(
    name="gpt-18b", n_layers=40, d_model=6144, vocab=50304, n_heads=48,
    n_kv_heads=48, head_dim=128, d_ff=24576)
gpt_18b = CONFIG_GPT_18B
