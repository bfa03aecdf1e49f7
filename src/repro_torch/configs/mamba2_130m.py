"""Architecture config (same dimensions as the reference's copy)."""
from repro_torch.configs.base import ArchConfig


# --- ssm ------------------------------------------------------------------
# SSD (state-space duality) [arXiv:2405.21060]
CONFIG_MAMBA2_130M = ArchConfig(
    name="mamba2-130m", n_layers=24, d_model=768, vocab=50280,
    pattern=("ssd",), ssm_state=128, ssm_headdim=64, ssm_expand=2,
    ssm_groups=1, ssm_chunk=128, long_context=True)
mamba2_130m = CONFIG_MAMBA2_130M
