"""Workspace path configuration (copy of the JAX package's ``paths.py``).

The workspace root comes from ``BAS_TPU_WORKDIR`` so both packages read and
write the same experiment and prediction layout. Experiment configs default
to the port's own copies in ``ball_action_spotting_torch/configs`` (the
repo's ``configs/`` import the JAX package).
"""

import os
from pathlib import Path


def work_dir() -> Path:
    return Path(os.environ.get("BAS_TPU_WORKDIR", os.getcwd()))


def data_dir() -> Path:
    return work_dir() / "data"


def configs_dir() -> Path:
    return Path(os.environ.get("BAS_TPU_CONFIGS_DIR", Path(__file__).parent / "configs"))


def soccernet_dir() -> Path:
    return data_dir() / "soccernet"
