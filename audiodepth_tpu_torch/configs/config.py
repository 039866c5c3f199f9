"""Typed 3-axis configuration system: dataset × mode × model.

The port's own copy of `audiodepth_tpu/configs/config.py` (the port imports
nothing of the JAX package): frozen dataclasses, built-in presets mirroring
conf/*.yaml, optional YAML file overrides, and dotted-path CLI overrides.
`resolve_compute_dtype` maps to torch dtypes.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field, fields, replace
from typing import Any, Dict, Optional, Tuple


@dataclass(frozen=True)
class DatasetConfig:
    name: str = "batvisionv2"
    dataset_dir: str = ""
    annotation_file_train: str = "train.csv"
    annotation_file_val: str = "val.csv"
    annotation_file_test: str = "test.csv"
    # transform parameters (conf/dataset/batvisionv{1,2}.yaml)
    audio_format: str = "mel_spectrogram"  # spectrogram | mel_spectrogram | waveform
    preprocess: str = "resize"
    depth_norm: bool = False
    images_size: int = 256
    max_depth: float = 30.0
    sample_rate: int = 44100


@dataclass(frozen=True)
class ModeConfig:
    mode: str = "train"
    experiment_name: str = "default"
    # train settings (conf/mode/train.yaml)
    checkpoints: Optional[int] = None       # epoch to resume/load
    saving_checkpoints: int = 10
    epochs: int = 200
    learning_rate: float = 0.002
    optimizer: str = "AdamW"                # Adam | AdamW | SGD
    weight_decay: float = 0.01
    sgd_momentum: float = 0.9
    criterion: str = "Combined"             # L1 | SIlog | Combined
    l1_weight: float = 0.237
    silog_weight: float = 0.637
    silog_lambda: float = 0.869
    validation: bool = True
    validation_iter: int = 2
    num_threads: int = 4
    batch_size: int = 256
    shuffle: bool = True
    grad_clip_norm: float = 1.0
    lr_schedule: str = "constant"           # constant | cosine | step | warm_restarts
    seed: int = 0
    # test settings (conf/mode/test.yaml)
    eval_on: str = "test"
    stat_dir: str = "./eval/"
    # engine
    compute_dtype: str = "bfloat16"         # bfloat16 | float32 | float64
    data_axis: str = "data"
    debug_nans: bool = False
    save_on_preempt: bool = True


@dataclass(frozen=True)
class ModelConfig:
    name: str = "unet_baseline"
    generator: str = "unet_256"             # unet_256 | unet_128
    ngf: int = 64
    norm: str = "batch"                     # batch | instance | none
    init_type: str = "normal"
    init_gain: float = 0.02
    use_dropout: bool = False
    input_nc: int = 2
    output_nc: int = 1
    # family-specific knobs (ignored by families that don't use them)
    base_channels: int = 64
    bilinear: bool = True
    attention_levels: Tuple[int, ...] = (2, 3, 4, 5)
    latent_dim: int = 128                   # cVAE
    kl_weight: float = 1e-4                 # cVAE
    n_bins: int = 128                       # adabins / coarse
    bin_strategy: str = "sid"               # linear | log | sid
    model_type: str = "unet"                # coarse family: unet|lite|hybrid|dual_reg
    extra: Dict[str, Any] = field(default_factory=dict)


@dataclass(frozen=True)
class Config:
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    mode: ModeConfig = field(default_factory=ModeConfig)
    model: ModelConfig = field(default_factory=ModelConfig)


# ---------------------------------------------------------------------------
# Built-in presets (mirror conf/*.yaml in the reference)
# ---------------------------------------------------------------------------

DATASET_PRESETS: Dict[str, DatasetConfig] = {
    "batvisionv1": DatasetConfig(
        name="batvisionv1",
        audio_format="spectrogram",
        depth_norm=True,
        max_depth=12.0,
    ),
    "batvisionv2": DatasetConfig(
        name="batvisionv2",
        audio_format="mel_spectrogram",
        depth_norm=False,
        max_depth=30.0,
    ),
    "synthetic": DatasetConfig(
        name="synthetic",
        audio_format="mel_spectrogram",
        depth_norm=False,
        max_depth=30.0,
    ),
}

MODE_PRESETS: Dict[str, ModeConfig] = {
    "train": ModeConfig(mode="train"),
    "test": ModeConfig(mode="test", criterion="L1", batch_size=1, checkpoints=50),
}

MODEL_PRESETS: Dict[str, ModelConfig] = {
    "unet_baseline": ModelConfig(name="unet_baseline", generator="unet_256"),
    "unet_cvae": ModelConfig(name="unet_cvae", generator="unet_256", latent_dim=128),
    "base_residual": ModelConfig(name="base_residual"),
    "binaural_attention": ModelConfig(name="binaural_attention"),
    "rgb_depth": ModelConfig(name="rgb_depth", input_nc=3),
    "adabins_distillation": ModelConfig(name="adabins_distillation", n_bins=128),
    "coarse_depth": ModelConfig(name="coarse_depth", n_bins=128),
    "spline_depth": ModelConfig(name="spline_depth", generator="spline_depth"),
}


def _coerce(value: Any, target_type: Any) -> Any:
    """Coerce a string override to the declared field type.

    Field annotations are strings here (PEP 563), so match on the name.
    """
    t = target_type if isinstance(target_type, str) else getattr(target_type, "__name__", str(target_type))
    if "bool" in t:
        if isinstance(value, bool):
            return value
        return str(value).lower() in ("1", "true", "yes")
    if "Tuple" in t or "tuple" in t:
        if isinstance(value, (tuple, list)):
            return tuple(int(v) for v in value)
        return tuple(int(v) for v in str(value).replace("[", "").replace("]", "").split(",") if v != "")
    if "int" in t:
        return int(value)
    if "float" in t:
        return float(value)
    return value


# Explicit-null override marker: plain None in an overrides dict means
# "flag not given, keep the preset" (argparse defaults).
NULL = object()


def apply_overrides(cfg: Config, overrides: Dict[str, Any]) -> Config:
    """Apply dotted-path overrides, e.g. {'mode.learning_rate': 1e-3}.

    None values are skipped (unset CLI flags); pass NULL to explicitly
    set a field to None.
    """
    groups: Dict[str, Dict[str, Any]] = {"dataset": {}, "mode": {}, "model": {}}
    extra_updates: Dict[str, Any] = {}
    for key, value in overrides.items():
        if value is None:
            continue
        if "." not in key:
            raise KeyError(f"override key must be dotted (group.field): {key!r}")
        group, name = key.split(".", 1)
        if group not in groups:
            raise KeyError(f"unknown config group {group!r} in override {key!r}")
        if group == "model" and name.startswith("extra."):
            extra_updates[name[len("extra."):]] = None if value is NULL else value
            continue
        groups[group][name] = value
    if extra_updates:
        merged = dict(groups["model"].get("extra", cfg.model.extra))
        merged.update(extra_updates)
        groups["model"]["extra"] = merged

    parts = {}
    for group, vals in groups.items():
        sub = getattr(cfg, group)
        if vals:
            type_by_name = {f.name: f.type for f in fields(sub)}
            coerced = {}
            for name, value in vals.items():
                if name not in type_by_name:
                    raise KeyError(f"unknown field {group}.{name}")
                coerced[name] = None if value is NULL else _coerce(value, type_by_name[name])
            sub = replace(sub, **coerced)
        parts[group] = sub
    return Config(**parts)


def _load_yaml_group(path: str) -> Dict[str, Any]:
    import yaml

    with open(path, "r") as f:
        data = yaml.safe_load(f) or {}
    return data


def load_config(
    dataset_name: str = "batvisionv2",
    mode: str = "train",
    experiment_name: str = "default",
    model_name: str = "unet_baseline",
    conf_dir: Optional[str] = None,
    overrides: Optional[Dict[str, Any]] = None,
) -> Config:
    """3-axis composition with the same signature shape as the reference loader.

    Presets come from the built-in tables; if ``conf_dir`` is given (or the
    env var ADEPTH_CONF_DIR points at a directory), YAML files
    ``{conf_dir}/dataset/{name}.yaml`` etc. override preset fields.
    """
    conf_dir = conf_dir or os.environ.get("ADEPTH_CONF_DIR")

    def build(group: str, name: str, presets: Dict[str, Any], cls):
        base = presets.get(name)
        if base is None:
            base = cls(name=name) if "name" in {f.name for f in fields(cls)} else cls()
        if conf_dir:
            path = os.path.join(conf_dir, group, f"{name}.yaml")
            if os.path.exists(path):
                data = _load_yaml_group(path)
                known = {f.name: f.type for f in fields(cls)}
                extra = {}
                updates = {}
                for k, v in data.items():
                    if k in known:
                        updates[k] = _coerce(v, known[k]) if v is not None else v
                    else:
                        extra[k] = v
                base = replace(base, **updates)
                if extra and hasattr(base, "extra"):
                    merged = dict(base.extra)
                    merged.update(extra)
                    base = replace(base, extra=merged)
        return base

    cfg = Config(
        dataset=build("dataset", dataset_name, DATASET_PRESETS, DatasetConfig),
        mode=replace(
            build("mode", mode, MODE_PRESETS, ModeConfig),
            mode=mode,
            experiment_name=experiment_name,
        ),
        model=build("model", model_name, MODEL_PRESETS, ModelConfig),
    )
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    validate(cfg)
    return cfg


def resolve_compute_dtype(cfg_or_name):
    """Map mode.compute_dtype to a torch dtype — the ONE place the mapping
    lives. bfloat16 is the default; float32 and float64 are the parity
    modes (configs/config.py:279-289 of the JAX package)."""
    import torch

    name = getattr(getattr(cfg_or_name, "mode", cfg_or_name), "compute_dtype",
                   cfg_or_name)
    return {"bfloat16": torch.bfloat16, "float64": torch.float64}.get(
        name, torch.float32)


def validate(cfg: Config) -> None:
    """Reject illegal combinations (the reference train.py guards)."""
    if cfg.mode.mode == "train":
        lr = cfg.mode.learning_rate
        if lr <= 0:
            raise ValueError(f"learning_rate must be > 0, got {lr}")
        if lr > 0.1:
            raise ValueError(f"learning_rate {lr} too large (> 0.1); refusing to train")
    if cfg.dataset.name == "batvisionv1" and "mel" in cfg.dataset.audio_format:
        raise ValueError("mel_spectrogram is not supported for batvisionv1")
