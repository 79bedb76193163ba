"""Experiment-config loading (copy of the JAX package's
``utils/experiments.py``): a config is a plain Python module named after the
experiment, under ``paths.configs_dir()/<domain>``, whose ``config`` dict
is the experiment."""

from __future__ import annotations

import importlib.util
from pathlib import Path

from ball_action_spotting_torch import paths
from ball_action_spotting_torch.domains.base import Domain


def load_experiment_config(experiment: str, domain: Domain,
                           configs_dir: Path | None = None) -> dict:
    configs_dir = Path(configs_dir or paths.configs_dir() / domain.name)
    config_path = configs_dir / f"{experiment}.py"
    if not config_path.exists():
        raise FileNotFoundError(f"Config '{config_path}' does not exist")
    spec = importlib.util.spec_from_file_location(experiment, config_path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)  # type: ignore[union-attr]
    return module.config


def num_decode_workers(config: dict) -> int:
    """Host decode worker count; accepts the reference's split NVDEC/OpenCV
    keys (``configs/ball_action/sampling_weights_001.py:25-26``) summed, or a
    native ``num_decode_workers``."""
    if "num_decode_workers" in config:
        return int(config["num_decode_workers"])
    return int(config.get("num_nvdec_workers", 0)) + int(
        config.get("num_opencv_workers", 0)
    ) or 4
