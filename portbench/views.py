"""The views a closed loop of frames renders: the configuration's camera
turned by a seed-drawn sub-pixel angle per frame, one progressive
anti-aliasing sample each. Every seed gives the same work (the same frame
size, depth and scene) in other sub-pixel positions."""

import numpy as np


def _turn(c2w, dx_px: float, dy_px: float, cam: dict, opts: dict):
    """c2w turned so that the image moves by (dx_px, dy_px) pixels at its
    centre: a yaw about the camera's up axis, then a pitch about its right
    axis, composed in float64 and rounded once to float32."""
    w, h = opts["width"], opts["height"]
    scale = np.tan(np.deg2rad(float(cam["fov"])) / 2.0)
    yaw = np.arctan(dx_px * 2.0 * scale * (w / h) / w)
    pitch = np.arctan(dy_px * 2.0 * scale / h)
    cy, sy, cp, sp = np.cos(yaw), np.sin(yaw), np.cos(pitch), np.sin(pitch)
    r_yaw = np.array([[cy, 0.0, sy], [0.0, 1.0, 0.0], [-sy, 0.0, cy]])
    r_pitch = np.array([[1.0, 0.0, 0.0], [0.0, cp, -sp], [0.0, sp, cp]])
    return (np.asarray(c2w, np.float64) @ r_yaw @ r_pitch).astype(np.float32)


class Views:
    """Frame k's view of a seed: offsets uniform in ±`jitter_px` pixels on
    each axis, drawn in frame order from `numpy.random.default_rng(seed)`
    (`seed` an integer, or a list of them for a stream of its own)."""

    def __init__(self, cfg: dict, seed: int, jitter_px: float):
        self.cam, self.opts = cfg["camera"], cfg["opts"]
        self.rng = np.random.default_rng(seed)
        self.jitter = float(jitter_px)

    def next(self) -> dict:
        dx, dy = self.rng.uniform(-self.jitter, self.jitter, 2)
        return {"pos": np.asarray(self.cam["pos"], np.float32),
                "c2w": _turn(self.cam["c2w"], dx, dy, self.cam, self.opts),
                "fov": float(self.cam["fov"])}


def still(cfg: dict) -> dict:
    """The configuration's own view, unturned."""
    cam = cfg["camera"]
    return {"pos": np.asarray(cam["pos"], np.float32),
            "c2w": np.asarray(cam["c2w"], np.float32), "fov": float(cam["fov"])}
