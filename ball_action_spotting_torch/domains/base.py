"""Domain descriptors (copy of the JAX package's ``domains/base.py``).

Each dataset/task instantiation of the spotting stack is a frozen ``Domain``
value; shared code takes a ``Domain`` argument rather than importing
task-specific constants.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Mapping

from ball_action_spotting_torch import paths


@dataclasses.dataclass(frozen=True)
class PostprocessParams:
    """Peak-extraction parameters."""

    gauss_sigma: float = 3.0
    height: float = 0.2
    distance: int = 15

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Domain:
    """A dataset/task instantiation of the spotting stack."""

    name: str
    classes: tuple[str, ...]
    label_file: str
    soccernet_subdir: str
    postprocess: PostprocessParams = PostprocessParams()
    video_fps: float = 25.0
    num_halves: int = 2
    # classes merged into one on input and mapped back on output
    merged_classes: Mapping[str, str] = dataclasses.field(default_factory=dict)
    output_class_map: Mapping[str, str] = dataclasses.field(default_factory=dict)
    # only annotations with this visibility are kept (None keeps all)
    visibility_filter: str | None = None

    @property
    def num_classes(self) -> int:
        return len(self.classes)

    @property
    def class2target(self) -> dict[str, int]:
        return {cls: i for i, cls in enumerate(self.classes)}

    @property
    def target2class(self) -> dict[int, str]:
        return {i: cls for i, cls in enumerate(self.classes)}

    @property
    def halves(self) -> list[int]:
        return list(range(1, self.num_halves + 1))

    @property
    def dir(self) -> Path:
        return paths.data_dir() / self.name

    @property
    def experiments_dir(self) -> Path:
        return self.dir / "experiments"

    @property
    def predictions_dir(self) -> Path:
        return self.dir / "predictions"

    @property
    def visualizations_dir(self) -> Path:
        return self.dir / "visualizations"

    @property
    def soccernet_dir(self) -> Path:
        return paths.soccernet_dir() / self.soccernet_subdir
