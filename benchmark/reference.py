"""The plain reference that the benchmark holds the fleet's step against.

Plain PyTorch, independent of the code under test: it imports nothing of
``visfs_tpu_torch`` (nor JAX) and takes nothing that the program derived.
It reads the images the benchmark made and, step by step, the program's own
outputs of a frame (where a track starts and ends, where its landmarks lie,
its pose), and works out from the images and the camera what those outputs
must satisfy:

* K1's tracks (the front end): a pyramidal Lucas-Kanade track that has
  converged is a fixed point of the Lucas-Kanade step at full resolution.
  ``lk_step`` is that step, over a 21 x 21 window of bilinear samples of
  the ``from`` image, its Scharr gradients and the ``to`` image, with the
  edge replicated beyond the border; the distance it would still move a
  track is what the comparison reads.  ``pyr_track`` is the whole
  pyramidal track (pyramids by ``pyr_down``), ``reverse_distance`` the
  reverse-flow check run from a track's end, and ``bidirectional`` both:
  with them the reference tracks again what the program kept and dropped.
* The estimator's pose (PnP and the window BA): the window BA leaves the
  newest pose at the optimum of its stereo reprojection terms, Huber-robust
  (delta 8 on chi2 at a pixel variance of 1.5), with the landmarks where
  the BA left them.  ``refine_planar_pose`` finds that optimum again from
  the program's pose, over x, y and yaw as the planar configuration states.
  The landmarks themselves are held against the scene (``camera_depth``
  beside ``scene.ray_depth``).
* The trajectory against the scene's ground truth is ``scene.span_ate``.

``pyr_track``, ``stereo_depth`` and ``refine_planar_pose`` also run in a
lower precision: the control that the comparison must reject
(``dtype=torch.bfloat16``; the points stay float32, as a bfloat16 flow
computation keeps them).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# image (x right, y down, z forward) -> robot (x forward, y left, z up)
_R_RI = ((0.0, 0.0, 1.0), (-1.0, 0.0, 0.0), (0.0, -1.0, 0.0))
PIXEL_VARIANCE = 1.5
HUBER_DELTA = 8.0


def _edge_padded(img, pad: int):
    h, w = img.shape[-2:]
    rows = torch.clamp(torch.arange(-pad, h + pad, device=img.device), 0,
                       h - 1)
    cols = torch.clamp(torch.arange(-pad, w + pad, device=img.device), 0,
                       w - 1)
    return img[..., rows[:, None], cols[None, :]]


def _sep3(img, kv, kh):
    """3 x 3 separable correlation (vertical taps kv, then horizontal kh),
    edges replicated."""
    p = _edge_padded(img, 1)
    h, w = img.shape[-2:]
    v = kv[0] * p[..., 0:h, :] + kv[1] * p[..., 1:h + 1, :] \
        + kv[2] * p[..., 2:h + 2, :]
    return kh[0] * v[..., :, 0:w] + kh[1] * v[..., :, 1:w + 1] \
        + kh[2] * v[..., :, 2:w + 2]


def scharr(img):
    """Scharr x and y gradients, scaled as OpenCV's pyramidal LK uses them
    (smoothing (3, 10, 3) / 16, central difference / 2)."""
    smooth = (3.0 / 16, 10.0 / 16, 3.0 / 16)
    diff = (-0.5, 0.0, 0.5)
    return _sep3(img, smooth, diff), _sep3(img, diff, smooth)


class Plane:
    """Images [S, Hp, Wp], already edge-padded by ``pad``, for bilinear
    window sampling."""

    def __init__(self, data, pad: int):
        self.data = data
        self.pad = pad

    def patches(self, pts, idx, win: int):
        """Bilinear samples of image idx [N] over the win x win window
        centred at pts [N, 2] (x, y): [N, win, win] (row = y).  The
        weights come from the window's corner pts - win // 2; only the
        integer corner is clipped, to [0, Wp - win - 2] x [0, Hp - win -
        2], so a window beyond the padded plane stops at its edge."""
        half = win // 2
        hp, wp = self.data.shape[-2:]
        c = pts + (self.pad - half)
        c0 = torch.floor(c)
        ax = (c[:, 0] - c0[:, 0]).to(self.data.dtype)[:, None, None]
        ay = (c[:, 1] - c0[:, 1]).to(self.data.dtype)[:, None, None]
        ix = torch.clamp(c0[:, 0].long(), 0, wp - win - 2)
        iy = torch.clamp(c0[:, 1].long(), 0, hp - win - 2)
        off = torch.arange(win, device=pts.device)
        xi = ix[:, None] + off  # [N, win]
        yi = iy[:, None] + off
        d = self.data
        n = idx[:, None, None]

        def at(yy, xx):
            return d[n, yy[:, :, None], xx[:, None, :]]

        return ((at(yi, xi) * (1 - ax) + at(yi, xi + 1) * ax) * (1 - ay)
                + (at(yi + 1, xi) * (1 - ax) + at(yi + 1, xi + 1) * ax) * ay)


class LKImages:
    """The from images [S, H, W] with their gradients and the to images,
    in ``dtype``: each edge-padded by win // 2 + 2, the gradients those of
    the padded image (zero across the replicated edge)."""

    def __init__(self, img_from, img_to, win: int, dtype=torch.float64):
        pad = win // 2 + 2
        f = _edge_padded(img_from.to(dtype), pad)
        gx, gy = scharr(f)
        self.win = win
        self.dtype = dtype
        self.i = Plane(f, pad)
        self.gx = Plane(gx, pad)
        self.gy = Plane(gy, pad)
        self.j = Plane(_edge_padded(img_to.to(dtype), pad), pad)


def lk_step(im: LKImages, pts_from, pts_to, idx):
    """The Lucas-Kanade step [N, 2] at full resolution from pts_to (where
    tracks of pts_from in image idx ended): G^-1 b with G the window's
    gradient matrix at pts_from and b the gradient-weighted difference of
    the two windows, in ``im``'s dtype (points float64 with float64
    images, else float32)."""
    pdt = _point_dtype(im)
    pf, pt = pts_from.to(pdt), pts_to.to(pdt)
    return _step(im, _window(im, pf, idx), pt, idx).to(pdt)


# --- the pyramidal track and its reverse -------------------------------------

_BINOMIAL5 = (1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16)


def pyr_down(img):
    """5-tap binomial blur with the edge replicated, then every other row
    and column from the first (cv::pyrDown: ceil(n / 2) of each)."""
    for axis in (-2, -1):
        n = img.shape[axis]
        base = 2 * torch.arange((n + 1) // 2, device=img.device) - 2
        out = 0
        for j, wgt in enumerate(_BINOMIAL5):
            out = out + wgt * torch.index_select(
                img, axis, torch.clamp(base + j, 0, n - 1))
        img = out
    return img


class PyrImages:
    """The from and to images [S, H, W] as pyramids of ``levels`` levels,
    each level an ``LKImages`` in ``dtype``."""

    def __init__(self, img_from, img_to, win: int, levels: int,
                 dtype=torch.float64):
        f, t = img_from.to(dtype), img_to.to(dtype)
        self.levels = []
        for lv in range(levels):
            if lv:
                f, t = pyr_down(f), pyr_down(t)
            self.levels.append(LKImages(f, t, win, dtype))
        self.height, self.width = img_from.shape[-2:]
        self.win = win


class _Window(NamedTuple):
    """The from side of a level's Lucas-Kanade window: the patch, its
    gradients and the gradient matrix."""

    ii: torch.Tensor
    gx: torch.Tensor
    gy: torch.Tensor
    g11: torch.Tensor
    g12: torch.Tensor
    g22: torch.Tensor
    det: torch.Tensor


def _window(im: LKImages, pts, idx) -> _Window:
    ii = im.i.patches(pts, idx, im.win)
    gx = im.gx.patches(pts, idx, im.win)
    gy = im.gy.patches(pts, idx, im.win)
    g11 = torch.sum(gx * gx, dim=(1, 2))
    g12 = torch.sum(gx * gy, dim=(1, 2))
    g22 = torch.sum(gy * gy, dim=(1, 2))
    return _Window(ii, gx, gy, g11, g12, g22, g11 * g22 - g12 * g12)


def _step(im: LKImages, w: _Window, pts_to, idx):
    """G^-1 b at pts_to for the window ``w``."""
    diff = w.ii - im.j.patches(pts_to, idx, im.win)
    b1 = torch.sum(diff * w.gx, dim=(1, 2))
    b2 = torch.sum(diff * w.gy, dim=(1, 2))
    det = torch.where(w.det.abs() > 0, w.det, torch.ones_like(w.det))
    return torch.stack([(w.g22 * b1 - w.g12 * b2) / det,
                        (w.g11 * b2 - w.g12 * b1) / det], dim=-1)


def pyr_track(pyr: PyrImages, pts_from, pts_init, idx, iterations: int = 30,
              eps: float = 0.01, min_eig: float = 1e-4):
    """Pyramidal Lucas-Kanade from image idx of ``pyr``'s from images at
    pts_from [N, 2] into its to images, from the guess pts_init, coarsest
    level first (each level's flow doubled into the next), each level
    iterated until the step is under ``eps`` pixels of that level or after
    ``iterations`` steps.  Returns (points [N, 2] float64, status [N]):
    status holds where every level's gradient matrix is well conditioned
    and the end lies inside [win // 2, size - win // 2) on both axes."""
    top = len(pyr.levels) - 1
    pdt = _point_dtype(pyr.levels[0])
    pf = pts_from.to(torch.float64)
    flow = (pts_init.to(torch.float64) - pf) / 2.0 ** top
    ok = torch.ones(len(pf), dtype=torch.bool, device=pf.device)
    for lv in range(top, -1, -1):
        im = pyr.levels[lv]
        pl = (pf / 2.0 ** lv).to(pdt)
        w = _window(im, pl, idx)
        tr = w.g11 + w.g22
        eig = (tr - torch.sqrt(torch.clamp(tr * tr - 4 * w.det, min=0))) \
            * 0.5 / (im.win * im.win)
        ok = ok & (eig > min_eig) & (w.det > 1e-12)
        run = torch.ones_like(ok)
        for _ in range(iterations):
            step = _step(im, w, pl + flow.to(pdt), idx).to(torch.float64)
            step = torch.where(torch.isfinite(step), step,
                               torch.zeros_like(step))
            flow = flow + torch.where(run[:, None], step,
                                      torch.zeros_like(step))
            run = run & (torch.sum(step * step, -1) >= eps * eps)
            if not bool(run.any()):
                break
        if lv:
            flow = flow * 2.0
    pt = pf + flow
    half = pyr.win // 2
    inb = ((pt[:, 0] >= half) & (pt[:, 0] < pyr.width - half)
           & (pt[:, 1] >= half) & (pt[:, 1] < pyr.height - half))
    return pt, ok & inb & torch.all(torch.isfinite(pt), -1)


def _point_dtype(im: LKImages):
    return torch.float64 if im.dtype == torch.float64 else torch.float32


def reverse_distance(pyr_back: PyrImages, pts_from, pts_to, idx, **kw):
    """The reverse track's distance: from pts_to in ``pyr_back``'s from
    images (the forward track's to images) back into its to images, seeded
    at pts_from, as the reverse-flow check runs it; inf where the reverse
    track fails."""
    back, ok = pyr_track(pyr_back, pts_to, pts_from, idx, **kw)
    d = torch.linalg.norm(back - pts_from.to(torch.float64), dim=-1)
    return torch.where(ok, d, torch.full_like(d, float("inf")))


def bidirectional(fwd: PyrImages, back: PyrImages, pts_from, pts_init, idx,
                  gate: float, **kw):
    """The forward track with the reverse-flow check: (points, status,
    reverse distance)."""
    pt, ok = pyr_track(fwd, pts_from, pts_init, idx, **kw)
    dist = reverse_distance(back, pts_from, pt, idx, **kw)
    return pt, ok & (dist <= gate), dist


def stereo_depth(uv_left, u_right, fx: float, baseline: float,
                 dtype=torch.float64):
    """The depth (m) of a stereo observation: fx * baseline / disparity, in
    ``dtype`` (inf for no positive disparity)."""
    d = uv_left[:, 0].to(dtype) - u_right.to(dtype)
    z = (fx * baseline) / torch.where(d > 0, d, torch.ones_like(d))
    return torch.where(d > 0, z, torch.full_like(z, float("inf"))).to(
        torch.float64)


# --- the pose ----------------------------------------------------------------

def camera_depth(T_wr, pw):
    """The depth (m along the camera's z) of world points pw [N, 3] seen
    from robot poses T_wr [N, 4, 4] (float64)."""
    T = T_wr.to(torch.float64)
    p_r = torch.einsum("nji,nj->ni", T[:, :3, :3],
                       pw.to(torch.float64) - T[:, :3, 3])
    return torch.einsum("ji,nj->ni", _r_ri(torch.float64, pw.device),
                        p_r)[:, 2]


def _r_ri(dtype, device):
    return torch.tensor(_R_RI, dtype=dtype, device=device)


def _rz(theta):
    c, s = torch.cos(theta), torch.sin(theta)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, z], -1), torch.stack([s, c, z], -1),
                        torch.stack([z, z, o], -1)], -2)


def stereo_residuals(R_wr, t_wr, pw, obs, cam):
    """obs (uL, vL, uR) [N, L, 3] less the stereo projection of world
    points pw [N, L, 3] through robot poses (R_wr [N, 3, 3], t_wr [N, 3])
    and the camera (fx, fy, cx, cy, baseline); also returns the image-frame
    points."""
    fx, fy, cx, cy, baseline = cam
    p_r = torch.einsum("nji,nlj->nli", R_wr, pw - t_wr[:, None])
    p_c = torch.einsum("ji,nlj->nli", _r_ri(pw.dtype, pw.device), p_r)
    z = p_c[..., 2]
    z = torch.where(z.abs() > 1e-3, z, torch.full_like(z, 1e-3))
    u = fx * p_c[..., 0] / z + cx
    v = fy * p_c[..., 1] / z + cy
    proj = torch.stack([u, v, u - baseline * fx / z], -1)
    return obs - proj, p_c


def refine_planar_pose(T_wr, pw, obs, mask, cam, iterations: int = 10,
                       dtype=torch.float64):
    """The newest pose at the optimum of its robust stereo terms, found
    again from T_wr [N, 4, 4] by Gauss-Newton over (x, y, yaw) with z, roll
    and pitch held, in ``dtype``: pw [N, L, 3] world landmarks, obs [N, L,
    3] (uL, vL, uR), mask [N, L].  Returns [N, 4, 4]."""
    T = T_wr.to(dtype)
    pw, obs = pw.to(dtype), obs.to(dtype)
    w_mask = mask.to(dtype)
    R0, t = T[:, :3, :3], T[:, :3, 3].clone()
    theta = torch.zeros(len(T), dtype=dtype, device=T.device)
    K = torch.tensor([[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, 0.0]],
                     dtype=dtype, device=T.device)
    r_ri = _r_ri(dtype, T.device)
    fx, fy, cx, cy, baseline = cam
    for _ in range(iterations):
        R = _rz(theta) @ R0
        r, p_c = stereo_residuals(R, t, pw, obs, cam)
        x, y, z = p_c[..., 0], p_c[..., 1], p_c[..., 2]
        z = torch.where(z.abs() > 1e-3, z, torch.full_like(z, 1e-3))
        zero = torch.zeros_like(z)
        dproj = torch.stack([
            torch.stack([fx / z, zero, -fx * x / (z * z)], -1),
            torch.stack([zero, fy / z, -fy * y / (z * z)], -1),
            torch.stack([fx / z, zero, -fx * x / (z * z)
                         + baseline * fx / (z * z)], -1)], -2)  # [N, L, 3, 3]
        # d p_r / d (x, y): -R^T e_x, -R^T e_y; d p_r / d yaw (left
        # increment Rz(d) R): R0^T Rz(theta)^T K (pw - t)
        rt = R.transpose(1, 2)
        dpr_dx = -rt[:, :, 0]
        dpr_dy = -rt[:, :, 1]
        dpr_dth = torch.einsum("nij,jk,nlk->nli", rt, K, pw - t[:, None])
        dpr = torch.stack([dpr_dx[:, None].expand_as(dpr_dth),
                           dpr_dy[:, None].expand_as(dpr_dth), dpr_dth],
                          -1)  # [N, L, 3, 3 params]
        dpc = torch.einsum("ji,nljp->nlip", r_ri, dpr)
        J = -dproj @ dpc  # d residual / d params [N, L, 3, 3]
        chi2 = torch.sum(r * r, -1) / PIXEL_VARIANCE
        e = torch.sqrt(torch.clamp(chi2, min=1e-12))
        huber = torch.where(chi2 > HUBER_DELTA ** 2, HUBER_DELTA / e,
                            torch.ones_like(e))
        w = w_mask * huber / PIXEL_VARIANCE
        H = torch.einsum("nl,nlkp,nlkq->npq", w, J, J)
        g = torch.einsum("nl,nlkp,nlk->np", w, J, r)
        H = H + 1e-9 * torch.eye(3, dtype=dtype, device=T.device)
        delta = -torch.linalg.solve(H.to(torch.float64),
                                    g.to(torch.float64)).to(dtype)
        t = t + torch.stack([delta[:, 0], delta[:, 1],
                             torch.zeros_like(delta[:, 0])], -1)
        theta = theta + delta[:, 2]
    out = T.clone()
    out[:, :3, :3] = _rz(theta) @ R0
    out[:, :3, 3] = t
    return out
