from .stft import (
    StftConfig,
    frame_signal,
    istft_packed,
    num_frames,
    overlap_add,
    pad_center,
    stft_packed,
)
from .windows import WINDOW_NAMES, get_window, padded_window

__all__ = [
    "StftConfig",
    "frame_signal",
    "istft_packed",
    "num_frames",
    "overlap_add",
    "pad_center",
    "stft_packed",
    "WINDOW_NAMES",
    "get_window",
    "padded_window",
]
