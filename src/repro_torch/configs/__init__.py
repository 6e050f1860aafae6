"""Configurations: the paper's own SVM experiments (``svm_paper``) and the
ten LM architecture files (copies of the reference's, pure data).
``get_config(name)`` -> ModelConfig; ``ARCHS`` lists the architectures.
"""
from __future__ import annotations

import importlib

ARCHS = [
    "granite_20b",
    "qwen3_1_7b",
    "stablelm_12b",
    "mistral_nemo_12b",
    "rwkv6_3b",
    "llama32_vision_90b",
    "mixtral_8x7b",
    "moonshot_v1_16b_a3b",
    "musicgen_large",
    "recurrentgemma_9b",
]

_ALIASES = {a.replace("_", "-"): a for a in ARCHS}
_ALIASES.update({
    "granite-20b": "granite_20b",
    "qwen3-1.7b": "qwen3_1_7b",
    "stablelm-12b": "stablelm_12b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "rwkv6-3b": "rwkv6_3b",
    "llama-3.2-vision-90b": "llama32_vision_90b",
    "mixtral-8x7b": "mixtral_8x7b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "musicgen-large": "musicgen_large",
    "recurrentgemma-9b": "recurrentgemma_9b",
})


def get_config(name: str):
    mod_name = _ALIASES.get(name, name)
    if mod_name not in ARCHS:
        raise KeyError(f"unknown architecture {name!r}; known: {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def all_configs():
    return {a: get_config(a) for a in ARCHS}
