"""FreeInit frequency-domain noise reinitialization.

Port of moca_tpu/freeinit.py: the low-pass filters are the same NumPy
builders (cached by shape), and `freq_mix_3d` runs on torch.fft in float32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _normalized_dist_sq(shape, d_s: float, d_t: float) -> np.ndarray:
    """d^2 grid used by all filters (freeinit_utils.py:89,111,132)."""
    T, H, W = shape[-3], shape[-2], shape[-1]
    t = (d_s / d_t) * (2.0 * np.arange(T) / T - 1.0)
    h = 2.0 * np.arange(H) / H - 1.0
    w = 2.0 * np.arange(W) / W - 1.0
    d2 = (t**2)[:, None, None] + (h**2)[None, :, None] + (w**2)[None, None, :]
    return np.broadcast_to(d2, shape)


def gaussian_low_pass_filter(shape, d_s=0.25, d_t=0.25) -> np.ndarray:
    if d_s == 0 or d_t == 0:
        return np.zeros(shape, np.float32)
    d2 = _normalized_dist_sq(shape, d_s, d_t)
    return np.exp(-1.0 / (2 * d_s**2) * d2).astype(np.float32)


def butterworth_low_pass_filter(shape, n=4, d_s=0.25, d_t=0.25) -> np.ndarray:
    if d_s == 0 or d_t == 0:
        return np.zeros(shape, np.float32)
    d2 = _normalized_dist_sq(shape, d_s, d_t)
    return (1.0 / (1.0 + (d2 / d_s**2) ** n)).astype(np.float32)


def ideal_low_pass_filter(shape, d_s=0.25, d_t=0.25) -> np.ndarray:
    """Thresholds at d^2 <= 2*d_s, literally as the reference does."""
    if d_s == 0 or d_t == 0:
        return np.zeros(shape, np.float32)
    d2 = _normalized_dist_sq(shape, d_s, d_t)
    return (d2 <= d_s * 2).astype(np.float32)


def box_low_pass_filter(shape, d_s=0.25, d_t=0.25) -> np.ndarray:
    if d_s == 0 or d_t == 0:
        return np.zeros(shape, np.float32)
    T, H, W = shape[-3], shape[-2], shape[-1]
    mask = np.zeros(shape, np.float32)
    ts = round(int(H // 2) * d_s)
    tt = round(T // 2 * d_t)
    cf, cr, cc = T // 2, H // 2, W // 2
    mask[..., cf - tt: cf + tt, cr - ts: cr + ts, cc - ts: cc + ts] = 1.0
    return mask


@functools.lru_cache(maxsize=8)
def _cached_filter_np(shape: tuple, filter_type: str, n: int, d_s: float,
                      d_t: float) -> np.ndarray:
    if filter_type == "gaussian":
        return gaussian_low_pass_filter(shape, d_s, d_t)
    if filter_type == "ideal":
        return ideal_low_pass_filter(shape, d_s, d_t)
    if filter_type == "box":
        return box_low_pass_filter(shape, d_s, d_t)
    if filter_type == "butterworth":
        return butterworth_low_pass_filter(shape, n, d_s, d_t)
    raise NotImplementedError(filter_type)


def get_freq_filter(shape, filter_type: str, n: int, d_s: float, d_t: float,
                    device=None) -> torch.Tensor:
    """The low-pass filter as a float32 tensor on `device`, cached there: a
    copy from the host would wait for the device's queued work, and the FIFO
    tail shift asks for the filter after every U-Net call. Callers must not
    write to it."""
    return _cached_filter(tuple(shape), filter_type, n, d_s, d_t,
                          torch.device("cpu" if device is None else device))


@functools.lru_cache(maxsize=8)
def _cached_filter(shape: tuple, filter_type: str, n: int, d_s: float, d_t: float,
                   device: torch.device) -> torch.Tensor:
    filt = _cached_filter_np(shape, filter_type, n, d_s, d_t)
    return torch.as_tensor(np.ascontiguousarray(filt), device=device)


def freq_mix_3d(x: torch.Tensor, noise: torch.Tensor, lpf: torch.Tensor) -> torch.Tensor:
    """Keep x's low frequencies, take noise's high frequencies.

    FFT over the last three axes (T, H, W) in float32."""
    dims = (-3, -2, -1)
    x_freq = torch.fft.fftshift(torch.fft.fftn(x.float(), dim=dims), dim=dims)
    n_freq = torch.fft.fftshift(torch.fft.fftn(noise.float(), dim=dims), dim=dims)
    lpf = lpf.float()
    mixed = x_freq * lpf + n_freq * (1.0 - lpf)
    out = torch.fft.ifftn(torch.fft.ifftshift(mixed, dim=dims), dim=dims).real
    return out.to(x.dtype)
