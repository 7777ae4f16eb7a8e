"""Architecture registry: ``--arch <id>`` resolution for launchers,
dry-runs, benchmarks and tests — the counterpart of
``repro.configs.registry``, loading ``repro_torch.configs.*``."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig  # noqa: F401

_MODULES = {
    "gemma3-27b": "repro_torch.configs.gemma3_27b",
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
    "glm4-9b": "repro_torch.configs.glm4_9b",
    "mistral-large-123b": "repro_torch.configs.mistral_large_123b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "rwkv6-7b": "repro_torch.configs.rwkv6_7b",
    "llama-3.2-vision-90b": "repro_torch.configs.llama32_vision_90b",
    "seamless-m4t-large-v2": "repro_torch.configs.seamless_m4t_v2",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
}

# Sub-quadratic archs: the only ones that run the long_500k decode cell
# (see docs/design-notes.md §7 for the skip rationale on the
# other eight).
SUBQUADRATIC = ("rwkv6-7b", "recurrentgemma-2b")


def list_archs() -> tuple[str, ...]:
    return tuple(_MODULES)


def get_config(name: str, *, smoke: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; know {list(_MODULES)}")
    mod = importlib.import_module(_MODULES[name])
    return mod.SMOKE if smoke else mod.FULL


def cell_is_runnable(arch: str, shape: str) -> tuple[bool, str]:
    """(runnable, reason-if-skipped) for an (arch x shape) dry-run cell."""
    if shape == "long_500k" and arch not in SUBQUADRATIC:
        return False, ("full-attention layers make 524k-token decode "
                       "quadratic-cost / unbounded-KV; skipped per "
                       "assignment (sub-quadratic archs only)")
    return True, ""
