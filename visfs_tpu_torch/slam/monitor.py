"""Monitor: debug visualization (torch port of visfs_tpu.slam.monitor; the
reference Monitor thread equivalent).

Mirrors corelib/src/Monitor.cpp:37-96 without the cv::imshow dependency:
renders the stitched stereo pair with tracked (red) / newly-extracted (blue)
/ blocked (yellow) keypoints, left-right match lines with per-match depth
labels (Monitor.cpp:76, via a built-in 3x5 bitmap font instead of
cv::putText), and the current submap image.  Output is plain numpy RGB
arrays the host can save or stream; rendering is pull-based from VOState
instead of a third thread + queue.  The state's tensors are fetched with
``.cpu()`` (a host sync: presentation only, nothing on the step calls
this); the drawing is the reference's numpy code.
"""

from __future__ import annotations

import os

import numpy as np
import torch

RED = (255, 64, 64)
BLUE = (64, 64, 255)
YELLOW = (255, 220, 0)
GREEN = (64, 220, 64)


def _np(x) -> np.ndarray:
    """A tensor (on any device) or array as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _to_rgb(img):
    g = np.clip(_np(img), 0, 255).astype(np.uint8)
    return np.stack([g, g, g], axis=-1)


def _draw_cross(img, x, y, color, size=2):
    h, w = img.shape[:2]
    x, y = int(round(x)), int(round(y))
    if not (0 <= x < w and 0 <= y < h):
        return
    img[max(0, y - size): y + size + 1, x] = color
    img[y, max(0, x - size): x + size + 1] = color


def _draw_line(img, x0, y0, x1, y1, color):
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1))
    xs = np.linspace(x0, x1, n).round().astype(int)
    ys = np.linspace(y0, y1, n).round().astype(int)
    h, w = img.shape[:2]
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[ok], xs[ok]] = color


# 3x5 bitmap glyphs for the depth labels (rows top-down, 3-bit masks).
_GLYPHS = {
    "0": (7, 5, 5, 5, 7), "1": (2, 6, 2, 2, 7), "2": (7, 1, 7, 4, 7),
    "3": (7, 1, 7, 1, 7), "4": (5, 5, 7, 1, 1), "5": (7, 4, 7, 1, 7),
    "6": (7, 4, 7, 5, 7), "7": (7, 1, 2, 2, 2), "8": (7, 5, 7, 5, 7),
    "9": (7, 5, 7, 1, 7), ".": (0, 0, 0, 0, 2), "-": (0, 0, 7, 0, 0),
}


def _draw_text(img, x, y, text, color):
    """Tiny bitmap text at (x, y) = top-left corner."""
    h, w = img.shape[:2]
    cx = int(round(x))
    for ch in str(text):
        g = _GLYPHS.get(ch)
        if g is not None:
            for r, bits in enumerate(g):
                for c in range(3):
                    if bits & (4 >> c):
                        yy, xx = int(round(y)) + r, cx + c
                        if 0 <= yy < h and 0 <= xx < w:
                            img[yy, xx] = color
        cx += 4


def render_frame(state, left, right) -> np.ndarray:
    """Stitched L|R debug image with keypoint overlays (Monitor.cpp:44-90)."""
    left_rgb = _to_rgb(left)
    right_rgb = _to_rgb(right)
    h, w = left_rgb.shape[:2]
    canvas = np.concatenate([left_rgb, right_rgb], axis=1)

    f = state.features
    cur = f.uv.shape[1] - 1
    valid = _np(f.valid)
    obs = _np(f.obs_mask[:, cur])
    uv = _np(f.uv[:, cur])
    uvr = _np(f.uv_right[:, cur])
    cnt = _np(f.track_cnt)
    depth = _np(f.depth[:, cur])
    start = _np(f.start_frame)
    frame_id = int(state.frame_count) - 1

    for i in np.nonzero(valid & obs)[0]:
        color = BLUE if start[i] == frame_id else RED
        _draw_cross(canvas, uv[i, 0], uv[i, 1], color)
        _draw_cross(canvas, uvr[i, 0] + w, uvr[i, 1], GREEN)
        if cnt[i] > 1:
            _draw_line(canvas, uv[i, 0], uv[i, 1], uvr[i, 0] + w, uvr[i, 1],
                       (80, 80, 80))
        # Per-match depth label next to the left keypoint (Monitor.cpp:76).
        z = float(depth[i])
        if np.isfinite(z) and z > 0:
            _draw_text(canvas, uv[i, 0] + 4, uv[i, 1] + 3, f"{z:.1f}", GREEN)

    blocked = _np(state.blocked_valid)
    buv = _np(state.blocked_uv)
    for i in np.nonzero(blocked)[0]:
        _draw_cross(canvas, buv[i, 0], buv[i, 1], YELLOW, size=3)
    return canvas


def render_submap(state) -> np.ndarray | None:
    """Current matching-submap occupancy image (Monitor.cpp:91-95)."""
    if state.laser is None:
        return None
    from ..map2d import grid2d
    from ..map2d.submap import has_matching_submap, matching_grid

    if not bool(has_matching_submap(state.laser.submaps)):
        return None
    grid = matching_grid(state.laser.submaps)
    return _np(grid2d.grid_to_image(grid, state.laser.cost_table))


class LiveMonitor:
    """Optional interactive display: the reference Monitor thread's
    cv::imshow windows (Monitor.cpp:37-96), shown when OpenCV is importable
    and a display exists; otherwise frames can be written to disk.

    Pull-based like the render functions — call ``show(state, left, right)``
    after each processed frame (e.g. from the host output loop).  This is
    presentation only; nothing in the engine depends on it.
    """

    def __init__(self, window: str = "visfs", save_dir: str | None = None,
                 wait_ms: int = 1):
        self.window = window
        self.save_dir = save_dir
        self.wait_ms = int(wait_ms)
        self._cv2 = None
        self._frame_idx = 0
        try:
            import cv2  # noqa: PLC0415 — optional

            self._cv2 = cv2
            # Qt's xcb plugin calls abort() (not catchable) when imshow
            # runs without a display server; only enable windows when one
            # exists.  Headless cv2 still serves imwrite below.
            self._windows_ok = bool(os.environ.get("DISPLAY")
                                    or os.environ.get("WAYLAND_DISPLAY"))
        except Exception:  # noqa: BLE001
            self._cv2 = None
            self._windows_ok = False
        if save_dir is not None:
            os.makedirs(save_dir, exist_ok=True)

    def show(self, state, left, right) -> np.ndarray:
        """Render + display (and/or save) one frame; returns the canvas."""
        canvas = render_frame(state, left, right)
        sub = render_submap(state)
        if self._cv2 is not None and self._windows_ok:
            cv2 = self._cv2
            try:
                cv2.imshow(self.window, canvas[..., ::-1])  # RGB -> BGR
                if sub is not None:
                    cv2.imshow(self.window + "/submap", sub)
                cv2.waitKey(self.wait_ms)
            except Exception:  # headless build of OpenCV
                self._windows_ok = False
        if self.save_dir is not None:
            path = f"{self.save_dir}/frame_{self._frame_idx:05d}"
            if self._cv2 is not None:
                self._cv2.imwrite(path + ".png", canvas[..., ::-1])
            else:
                np.save(path + ".npy", canvas)
        self._frame_idx += 1
        return canvas

    def close(self) -> None:
        if self._cv2 is not None and self._windows_ok:
            try:
                self._cv2.destroyWindow(self.window)
                self._cv2.destroyWindow(self.window + "/submap")
            except Exception:  # noqa: BLE001
                pass
