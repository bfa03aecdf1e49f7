"""Architecture registry of the port: the configs its slices run."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.gemma3_4b import gemma3_4b
from repro_torch.configs.gpt_zeropp import gpt_350m
from repro_torch.configs.qwen3_0_6b import qwen3_0_6b

_R: Dict[str, ArchConfig] = {c.name: c for c in [qwen3_0_6b, gpt_350m,
                                                gemma3_4b]}


def get_config(name: str) -> ArchConfig:
    key = name.replace("_", "-")
    if key not in _R:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_R)}")
    return _R[key]
