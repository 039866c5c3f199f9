from .config import (
    Config,
    DatasetConfig,
    ModeConfig,
    ModelConfig,
    DATASET_PRESETS,
    MODE_PRESETS,
    MODEL_PRESETS,
    NULL,
    apply_overrides,
    load_config,
    resolve_compute_dtype,
    validate,
)

__all__ = [
    "Config",
    "DatasetConfig",
    "ModeConfig",
    "ModelConfig",
    "DATASET_PRESETS",
    "MODE_PRESETS",
    "MODEL_PRESETS",
    "NULL",
    "apply_overrides",
    "load_config",
    "resolve_compute_dtype",
    "validate",
]
