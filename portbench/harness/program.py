"""What the benchmark hands the program: its configuration object, built
from a configuration file's ``model`` fields."""
from __future__ import annotations


def config(model: dict):
    from repro_torch.models.config import ModelConfig
    return ModelConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in model.items()})
