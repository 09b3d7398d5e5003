"""Architecture registry of the port: ``get(name)`` -> full ModelConfig,
``get_smoke(name)`` -> reduced variant.  Only tinyllama-1.1b and its
sliding-window variant are ported; every other arch of ``repro.configs``
raises."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, TrainConfig  # noqa: F401

_MODULES = {"tinyllama-1.1b": "tinyllama_1_1b",
            "tinyllama-1.1b-swa": "tinyllama_1_1b_swa"}

# the other archs of the reference registry, still to be ported
_NOT_PORTED = (
    "musicgen-medium", "granite-34b", "deepseek-v2-236b",
    "granite-moe-3b-a800m", "qwen2-vl-7b", "deepseek-coder-33b",
    "recurrentgemma-2b", "stablelm-1.6b", "mamba2-130m",
)


def _module(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(f"arch {name!r} is not ported yet; "
                                  f"ported: {sorted(_MODULES)}")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _module(name).SMOKE
