from ball_action_spotting_torch.data.dataset import (
    ClipDataset,
    TrainClipDataset,
    ValClipDataset,
    pad_frames,
)
from ball_action_spotting_torch.data.loader import ClipLoader, prefetch_to_device
from ball_action_spotting_torch.data.video import (
    FrameSource,
    HardSyntheticSource,
    OpenCVSource,
    SyntheticSource,
    make_synthetic_video_data,
    open_source,
)

__all__ = [
    "ClipDataset",
    "ClipLoader",
    "FrameSource",
    "HardSyntheticSource",
    "OpenCVSource",
    "SyntheticSource",
    "TrainClipDataset",
    "ValClipDataset",
    "make_synthetic_video_data",
    "open_source",
    "pad_frames",
    "prefetch_to_device",
]
