"""Window-function registry for the STFT/ISTFT front-ends.

A numpy copy of ``audiojax.dsp.windows``: the port keeps its own so that it
never imports the JAX package.  Windows are built in float64 on the host and
folded into the DFT bases; they never exist as tensors of their own.

torch's ``periodic=True`` windows are the symmetric window of length ``L+1``
with the last sample dropped; the symmetric forms are implemented directly
and the periodic ones derived from them.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "get_window",
    "padded_window",
    "WINDOW_NAMES",
]


def _hann_sym(n: int) -> np.ndarray:
    if n == 1:
        return np.ones(1)
    k = np.arange(n, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * k / (n - 1))


def _hamming_sym(n: int) -> np.ndarray:
    if n == 1:
        return np.ones(1)
    k = np.arange(n, dtype=np.float64)
    return 0.54 - 0.46 * np.cos(2.0 * np.pi * k / (n - 1))


def _bartlett_sym(n: int) -> np.ndarray:
    if n == 1:
        return np.ones(1)
    k = np.arange(n, dtype=np.float64)
    return 1.0 - np.abs(2.0 * k / (n - 1) - 1.0)


def _blackman_sym(n: int) -> np.ndarray:
    if n == 1:
        return np.ones(1)
    k = np.arange(n, dtype=np.float64)
    w = 2.0 * np.pi * k / (n - 1)
    return 0.42 - 0.5 * np.cos(w) + 0.08 * np.cos(2.0 * w)


def _kaiser_sym(n: int, beta: float = 12.0) -> np.ndarray:
    if n == 1:
        return np.ones(1)
    k = np.arange(n, dtype=np.float64)
    alpha = (n - 1) / 2.0
    return np.i0(beta * np.sqrt(np.maximum(1.0 - ((k - alpha) / alpha) ** 2, 0.0))) / np.i0(beta)


def _periodic(sym_fn, n: int, **kw) -> np.ndarray:
    if n == 1:
        return np.ones(1)
    return sym_fn(n + 1, **kw)[:-1]


# The periodic/symmetric hamming split serves DFSMN-style front-ends.
_WINDOWS = {
    "bartlett": lambda n: _periodic(_bartlett_sym, n),
    "blackman": lambda n: _periodic(_blackman_sym, n),
    "hamming": lambda n: _periodic(_hamming_sym, n),
    "hamming_periodic": lambda n: _periodic(_hamming_sym, n),
    "hamming_symmetric": _hamming_sym,
    "hann": lambda n: _periodic(_hann_sym, n),
    "hann_sqrt": lambda n: np.sqrt(_periodic(_hann_sym, n)),
    "povey": lambda n: _hann_sym(n) ** 0.85,
    "kaiser": lambda n: _periodic(_kaiser_sym, n),
    "rect": lambda n: np.ones(n, dtype=np.float64),
}

WINDOW_NAMES = tuple(sorted(_WINDOWS))


def get_window(name: str, length: int) -> np.ndarray:
    """Return the named window of ``length`` samples as float64.

    Unknown names fall back to periodic hann, as in the JAX package.
    """
    fn = _WINDOWS.get(name, _WINDOWS["hann"])
    return np.asarray(fn(length), dtype=np.float64)


def padded_window(name: str, win_length: int, n_fft: int) -> np.ndarray:
    """Window of length ``win_length`` centre-padded (or cropped) to ``n_fft``."""
    win = get_window(name, win_length)
    if win_length == n_fft:
        return win
    if win_length < n_fft:
        pad = n_fft - win_length
        left = pad // 2
        return np.concatenate([np.zeros(left), win, np.zeros(pad - left)])
    start = (win_length - n_fft) // 2
    return win[start : start + n_fft]
