"""Architecture registry: arch id -> ModelConfig.

The port serves the dense GQA family (every layer attention + dense MLP).
The other architectures of the JAX package's registry need mixers or
layers that later slices port; `get_config` names that slice."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

ARCH_IDS = (
    "llama3_8b",
    "qwen2_7b",
    "internlm2_1_8b",
    "deepseek_7b",
)

# the JAX package's other architectures, and the slice each waits for
LATER_SLICES = {
    "phi_3_vision_4_2b": "the VLM slice (vision frontend)",
    "deepseek_v3_671b": "the MoE and MLA slices",
    "dbrx_132b": "the MoE slice",
    "jamba_v0_1_52b": "the hybrid slice (Mamba + MoE)",
    "xlstm_350m": "the xLSTM slice",
    "whisper_tiny": "the enc-dec slice",
}


def get_config(arch: str) -> ModelConfig:
    key = arch.replace("-", "_").replace(".", "_")
    if key in LATER_SLICES:
        raise NotImplementedError(
            f"arch '{arch}' is not ported yet: it waits for "
            f"{LATER_SLICES[key]}; the port serves {ARCH_IDS}")
    if key not in ARCH_IDS:
        raise KeyError(f"unknown arch '{arch}'; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{key}").CONFIG


def all_configs() -> dict[str, ModelConfig]:
    return {aid: get_config(aid) for aid in ARCH_IDS}
