from ball_action_spotting_torch.data.video import (
    FrameSource,
    OpenCVSource,
    SyntheticSource,
    open_source,
)

__all__ = ["FrameSource", "OpenCVSource", "SyntheticSource", "open_source"]
