"""Seeded synthetic video for the benchmark's clips: a textured background
under a camera pan at sub-pixel steps, textured objects moving across
it, and noise in every frame.  Pure NumPy; used by ``make_streams.py``."""

from __future__ import annotations

import numpy as np


def smooth_noise(rng, h, w, cell):
    """Unit-variance noise on a grid of ``cell`` pixels, bilinearly
    interpolated to ``h`` x ``w`` (float32)."""
    gh, gw = h // cell + 2, w // cell + 2
    g = rng.standard_normal((gh, gw)).astype(np.float32)
    x = np.arange(w, dtype=np.float32) / cell
    x0 = x.astype(np.int64)
    fx = x - x0
    rows = g[:, x0] * (1 - fx) + g[:, x0 + 1] * fx
    y = np.arange(h, dtype=np.float32) / cell
    y0 = y.astype(np.int64)
    fy = (y - y0)[:, None]
    return rows[y0] * (1 - fy) + rows[y0 + 1] * fy


def texture(rng, h, w, scale):
    """Octaves of smooth noise plus hard-edged blobs, around 0."""
    t = np.zeros((h, w), np.float32)
    for cell, amp in ((96, 28.0), (24, 14.0), (6, 7.0), (2, 3.0)):
        t += amp * smooth_noise(rng, h, w, max(1, int(cell * scale)))
    edges = smooth_noise(rng, h, w, max(2, int(40 * scale)))
    t += np.where(edges > 0.5, 30.0, 0.0) - np.where(edges < -0.9, 25.0, 0.0)
    return t


class Scene:
    """Frames ``[y, u, v]`` of one clip, made one at a time from
    ``seed``: values in ``[0, 2**bitdepth)``, 4:2:0."""

    def __init__(self, seed, width, height, bitdepth, n_frames,
                 n_objects=8, noise=2.5, detail=None):
        """``detail``: the texture's scale against 1080p (default the
        frame's width over 1920; smaller is finer)."""
        rng = np.random.default_rng(seed)
        self.rng, self.w, self.h = rng, width, height
        self.bitdepth, self.noise = bitdepth, noise
        motion = width / 1920
        scale = motion if detail is None else detail
        speed = rng.uniform(1.5, 3.0) * motion
        ang = rng.uniform(0, 2 * np.pi)
        self.pan = (speed * np.cos(ang), speed * np.sin(ang) * 0.5)
        self.margin = int(np.ceil(speed * n_frames)) + 8
        m = self.margin
        bh, bw = height + 2 * m, width + 2 * m
        self.bg_y = 110 + texture(rng, bh, bw, scale)
        self.bg_u = 128 + 18 * smooth_noise(rng, bh, bw, int(160 * motion))
        self.bg_v = 128 + 18 * smooth_noise(rng, bh, bw, int(160 * motion))
        self.objects = []
        for _ in range(n_objects):
            oh = int(rng.uniform(0.08, 0.3) * height)
            ow = int(rng.uniform(0.06, 0.25) * width)
            yy, xx = np.mgrid[0:oh, 0:ow]
            ellipse = rng.random() < 0.5
            mask = (((yy - oh / 2) / (oh / 2)) ** 2
                    + ((xx - ow / 2) / (ow / 2)) ** 2 <= 1) if ellipse \
                else np.ones((oh, ow), bool)
            self.objects.append({
                "y": rng.uniform(0, height - oh), "x": rng.uniform(0, width - ow),
                "vy": rng.uniform(-5, 5) * motion,
                "vx": rng.uniform(-7, 7) * motion,
                "tex": rng.uniform(60, 190) + texture(rng, oh, ow, scale * 0.5),
                "u": rng.uniform(-40, 40), "v": rng.uniform(-40, 40),
                "mask": mask,
            })
        self.t = 0

    def _crop(self, plane):
        m = self.margin
        oy = m + self.pan[1] * self.t
        ox = m + self.pan[0] * self.t
        iy, ix = int(np.floor(oy)), int(np.floor(ox))
        fy, fx = oy - iy, ox - ix
        h, w = self.h, self.w
        a = plane[iy:iy + h, ix:ix + w]
        b = plane[iy:iy + h, ix + 1:ix + w + 1]
        c = plane[iy + 1:iy + h + 1, ix:ix + w]
        d = plane[iy + 1:iy + h + 1, ix + 1:ix + w + 1]
        return ((1 - fy) * ((1 - fx) * a + fx * b)
                + fy * ((1 - fx) * c + fx * d))

    def next(self):
        y, u, v = (self._crop(p) for p in (self.bg_y, self.bg_u, self.bg_v))
        for o in self.objects:
            oh, ow = o["mask"].shape
            y0 = int(round(o["y"] + o["vy"] * self.t)) % (self.h - oh)
            x0 = int(round(o["x"] + o["vx"] * self.t)) % (self.w - ow)
            sl = (slice(y0, y0 + oh), slice(x0, x0 + ow))
            mk = o["mask"]
            y[sl][mk] = o["tex"][mk]
            u[sl][mk] += o["u"]
            v[sl][mk] += o["v"]
        y = y + self.noise * self.rng.standard_normal(y.shape, np.float32)
        u = u[0::2, 0::2] + u[1::2, 0::2] + u[0::2, 1::2] + u[1::2, 1::2]
        v = v[0::2, 0::2] + v[1::2, 0::2] + v[0::2, 1::2] + v[1::2, 1::2]
        u = u / 4 + self.noise / 2 * self.rng.standard_normal(u.shape,
                                                              np.float32)
        v = v / 4 + self.noise / 2 * self.rng.standard_normal(v.shape,
                                                              np.float32)
        self.t += 1
        top = (1 << self.bitdepth) - 1
        k = 1 << (self.bitdepth - 8)
        return [np.clip(np.rint(p * k), 0, top).astype(np.uint16)
                for p in (y, u, v)]
