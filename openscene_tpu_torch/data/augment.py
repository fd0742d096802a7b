"""3D point-cloud augmentations (host-side, NumPy).

Same augmentation family and probabilities as the reference
``dataset/augmentation.py``: chromatic translation / auto-contrast / jitter,
hue-saturation shift, random horizontal flip, and elastic distortion
(smoothed Gaussian noise grid + trilinear displacement).  All transforms take
an explicit ``np.random.Generator`` instead of global RNG state so the eval
repeats protocol can reseed deterministically.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import scipy.interpolate
import scipy.ndimage


class Transform:
    def __init__(self, rng: Optional[np.random.Generator] = None):
        self.rng = rng if rng is not None else np.random.default_rng()

    def reseed(self, rng: np.random.Generator):
        self.rng = rng


class ChromaticTranslation(Transform):
    """Shift all colors by one random RGB offset; applied w.p. 0.95."""

    def __init__(self, trans_range_ratio: float = 0.1, rng=None):
        super().__init__(rng)
        self.trans_range_ratio = trans_range_ratio

    def __call__(self, coords, feats, labels):
        if self.rng.random() < 0.95:
            tr = (self.rng.random((1, 3)) - 0.5) * 255 * 2 * self.trans_range_ratio
            feats = feats.copy()
            feats[:, :3] = np.clip(tr + feats[:, :3], 0, 255)
        return coords, feats, labels


class ChromaticAutoContrast(Transform):
    """Blend towards full-range contrast stretch; applied w.p. 0.2."""

    def __init__(self, randomize_blend_factor: bool = True,
                 blend_factor: float = 0.5, rng=None):
        super().__init__(rng)
        self.randomize_blend_factor = randomize_blend_factor
        self.blend_factor = blend_factor

    def __call__(self, coords, feats, labels):
        if self.rng.random() < 0.2:
            lo = feats.min(0, keepdims=True)
            hi = feats.max(0, keepdims=True)
            scale = 255 / (hi - lo)
            contrast = (feats - lo) * scale
            blend = self.rng.random() if self.randomize_blend_factor else self.blend_factor
            feats = (1 - blend) * feats + blend * contrast
        return coords, feats, labels


class ChromaticJitter(Transform):
    """Per-point Gaussian color noise; applied w.p. 0.95."""

    def __init__(self, std: float = 0.01, rng=None):
        super().__init__(rng)
        self.std = std

    def __call__(self, coords, feats, labels):
        if self.rng.random() < 0.95:
            noise = self.rng.standard_normal((feats.shape[0], 3)) * self.std * 255
            feats = feats.copy()
            feats[:, :3] = np.clip(noise + feats[:, :3], 0, 255)
        return coords, feats, labels


def rgb_to_hsv(rgb: np.ndarray) -> np.ndarray:
    """Vectorized colorsys.rgb_to_hsv; rgb in [0,255], h/s in [0,1], v=[0,255]."""
    rgb = rgb.astype(np.float64)
    hsv = np.zeros_like(rgb)
    hsv[..., 3:] = rgb[..., 3:]
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = rgb[..., :3].max(axis=-1)
    minc = rgb[..., :3].min(axis=-1)
    hsv[..., 2] = maxc
    mask = maxc != minc
    span = np.where(mask, maxc - minc, 1.0)
    hsv[..., 1] = np.where(mask, (maxc - minc) / np.where(maxc == 0, 1.0, maxc), 0.0)
    rc = np.where(mask, (maxc - r) / span, 0.0)
    gc = np.where(mask, (maxc - g) / span, 0.0)
    bc = np.where(mask, (maxc - b) / span, 0.0)
    h = np.select([r == maxc, g == maxc], [bc - gc, 2.0 + rc - bc],
                  default=4.0 + gc - rc)
    hsv[..., 0] = (h / 6.0) % 1.0
    return hsv


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """Vectorized colorsys.hsv_to_rgb; returns uint8 RGB."""
    rgb = np.empty_like(hsv)
    rgb[..., 3:] = hsv[..., 3:]
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = (h * 6.0).astype(np.uint8)
    f = (h * 6.0) - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i % 6
    conds = [s == 0.0, i == 1, i == 2, i == 3, i == 4, i == 5]
    rgb[..., 0] = np.select(conds, [v, q, p, p, t, v], default=v)
    rgb[..., 1] = np.select(conds, [v, v, v, q, p, p], default=t)
    rgb[..., 2] = np.select(conds, [v, p, t, v, v, q], default=p)
    return rgb.astype(np.uint8)


class HueSaturationTranslation(Transform):
    def __init__(self, hue_max: float = 0.5, saturation_max: float = 0.2, rng=None):
        super().__init__(rng)
        self.hue_max = hue_max
        self.saturation_max = saturation_max

    def __call__(self, coords, feats, labels):
        hsv = rgb_to_hsv(feats[:, :3])
        hue_val = (self.rng.random() - 0.5) * 2 * self.hue_max
        sat_ratio = 1 + (self.rng.random() - 0.5) * 2 * self.saturation_max
        hsv[..., 0] = np.remainder(hue_val + hsv[..., 0] + 1, 1)
        hsv[..., 1] = np.clip(sat_ratio * hsv[..., 1], 0, 1)
        feats = feats.copy()
        feats[:, :3] = np.clip(hsv_to_rgb(hsv), 0, 255)
        return coords, feats, labels


class RandomHorizontalFlip(Transform):
    """Mirror each non-upright axis independently w.p. 0.5 (gated w.p. 0.95)."""

    def __init__(self, upright_axis: str = "z", is_temporal: bool = False, rng=None):
        super().__init__(rng)
        self.D = 4 if is_temporal else 3
        self.upright_axis = {"x": 0, "y": 1, "z": 2}[upright_axis.lower()]
        self.horz_axes = sorted(set(range(self.D)) - {self.upright_axis})

    def __call__(self, coords, feats, labels):
        if self.rng.random() < 0.95:
            coords = coords.copy()
            for ax in self.horz_axes:
                if self.rng.random() < 0.5:
                    coords[:, ax] = coords[:, ax].max() - coords[:, ax]
        return coords, feats, labels


class ElasticDistortion(Transform):
    """Smoothed-noise-grid elastic displacement (pre-voxelization)."""

    def __init__(self, distortion_params: Sequence[Tuple[float, float]], rng=None):
        super().__init__(rng)
        self.distortion_params = distortion_params

    def distort(self, coords: np.ndarray, granularity: float,
                magnitude: float) -> np.ndarray:
        coords_min = coords.min(0)
        noise_dim = ((coords - coords_min).max(0) // granularity).astype(int) + 3
        noise = self.rng.standard_normal((*noise_dim, 3)).astype(np.float32)
        # Two passes of separable box blur along each axis.
        for _ in range(2):
            for ax in range(3):
                noise = scipy.ndimage.uniform_filter1d(
                    noise, size=3, axis=ax, mode="constant", cval=0.0)
        grid_axes = [
            np.linspace(d_min, d_max, d)
            for d_min, d_max, d in zip(coords_min - granularity,
                                       coords_min + granularity * (noise_dim - 2),
                                       noise_dim)
        ]
        interp = scipy.interpolate.RegularGridInterpolator(
            grid_axes, noise, bounds_error=False, fill_value=0)
        return coords + interp(coords) * magnitude

    def __call__(self, coords: np.ndarray) -> np.ndarray:
        if self.distortion_params is not None and self.rng.random() < 0.95:
            for granularity, magnitude in self.distortion_params:
                coords = self.distort(coords, granularity, magnitude)
        return coords


class Compose:
    def __init__(self, transforms: List):
        self.transforms = transforms

    def reseed(self, rng: np.random.Generator):
        for t in self.transforms:
            if hasattr(t, "reseed"):
                t.reseed(rng)

    def __call__(self, *args):
        for t in self.transforms:
            args = t(*args)
            if not isinstance(args, tuple):
                args = (args,)
        return args if len(args) > 1 else args[0]
