"""The reference's architecture configs.

``get_config(name)`` returns the full config, ``get_smoke_config(name)``
the reduced same-family config the CPU tests run; both are copies of the
reference's ``CONFIG`` and ``SMOKE``. The port serves all ten: the dense
attention family (qwen3-1.7b, qwen1.5-32b, nemotron-4-15b,
starcoder2-15b), MoE (dbrx-132b, llama4-scout-17b-a16e), the frontend
stubs over dense backbones (internvl2-1b, musicgen-medium), the Mamba2
hybrid (zamba2-2.7b) and RWKV6 (rwkv6-3b).
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCHS = (
    "dbrx_132b",
    "llama4_scout_17b_a16e",
    "qwen3_1p7b",
    "qwen1p5_32b",
    "nemotron_4_15b",
    "starcoder2_15b",
    "internvl2_1b",
    "musicgen_medium",
    "zamba2_2p7b",
    "rwkv6_3b",
)
# the archs whose configs and model code the port has: every one
PORTED = ARCHS
# layers of a full-width MoE arch that fit one 80 GB H100 in bf16 beside B
# = 8 caches of 4,096 positions and the prefill's expert buffers (the
# whole models hold 263 and 216 GB)
ONE_CARD_LAYERS = {"dbrx-132b": 8, "llama4-scout-17b-a16e": 12}

# canonical ids -> module names
ALIASES = {
    "dbrx-132b": "dbrx_132b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "qwen3-1.7b": "qwen3_1p7b",
    "qwen1.5-32b": "qwen1p5_32b",
    "nemotron-4-15b": "nemotron_4_15b",
    "starcoder2-15b": "starcoder2_15b",
    "internvl2-1b": "internvl2_1b",
    "musicgen-medium": "musicgen_medium",
    "zamba2-2.7b": "zamba2_2p7b",
    "rwkv6-3b": "rwkv6_3b",
}


def _module(name: str):
    mod_name = ALIASES.get(name, name).replace("-", "_").replace(".", "p")
    if mod_name not in PORTED:
        raise KeyError(f"unknown arch {name!r}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).SMOKE
