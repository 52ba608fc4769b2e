from . import stft  # the module, callable as its function stft (see dsp/stft.py)
from .stft import (
    StftConfig,
    frame_signal,
    istft,
    istft_length,
    istft_packed,
    istft_polar,
    num_frames,
    overlap_add,
    pad_center,
    stft_packed,
    stft_real,
)
from .windows import WINDOW_NAMES, get_window, padded_window

__all__ = [
    "StftConfig",
    "frame_signal",
    "istft",
    "istft_length",
    "istft_packed",
    "istft_polar",
    "num_frames",
    "overlap_add",
    "pad_center",
    "stft",
    "stft_packed",
    "stft_real",
    "WINDOW_NAMES",
    "get_window",
    "padded_window",
]
