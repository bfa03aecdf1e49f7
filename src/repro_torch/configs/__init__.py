"""Architecture registry of the port: the reference's dense, MoE, SSM and
hybrid configs."""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.deepseek_moe_16b import deepseek_moe_16b
from repro_torch.configs.gemma3_4b import gemma3_4b
from repro_torch.configs.gpt_zeropp import gpt_18b, gpt_350m
from repro_torch.configs.mamba2_130m import mamba2_130m
from repro_torch.configs.musicgen_large import musicgen_large
from repro_torch.configs.qwen1_5_110b import qwen1_5_110b
from repro_torch.configs.qwen2_vl_72b import qwen2_vl_72b
from repro_torch.configs.qwen3_0_6b import qwen3_0_6b
from repro_torch.configs.qwen3_moe_235b_a22b import qwen3_moe_235b_a22b
from repro_torch.configs.recurrentgemma_2b import recurrentgemma_2b
from repro_torch.configs.starcoder2_3b import starcoder2_3b

_R: Dict[str, ArchConfig] = {c.name: c for c in [
    deepseek_moe_16b, qwen3_moe_235b_a22b, musicgen_large, qwen2_vl_72b,
    qwen1_5_110b, qwen3_0_6b, starcoder2_3b, gemma3_4b, gpt_350m, gpt_18b,
    mamba2_130m, recurrentgemma_2b]}


def get_config(name: str) -> ArchConfig:
    key = name.replace("_", "-")
    if key not in _R:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_R)}")
    return _R[key]


def list_archs() -> List[str]:
    """Every registered name, sorted."""
    return sorted(_R)
