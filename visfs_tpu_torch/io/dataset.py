"""Dataset directory readers: EuRoC-ASL stereo and TUM-RGBD formats (the
port's own copy of visfs_tpu.io.dataset; numpy and PIL, no torch math).

The reference operates on live ROS topics / recorded rosbags
(reference README.md:44-56, Interface/ROS/src/InterfaceROS.cpp:180-223);
the standard offline substitutes in the visual-SLAM community are the
EuRoC MAV ASL directory layout (stereo + ground truth) and the TUM RGB-D
layout (rgb + depth + ground truth).  This module reads both into a
uniform host-side :class:`DatasetSequence` that feeds
``System.run_sequence`` directly (strategy 0 for EuRoC stereo, strategy 1
for TUM RGB-D via the depth -> virtual-disparity unification), and can
write a simulated :class:`visfs_tpu_torch.io.sim.SimSequence` out in either
format so the readers are testable without shipping real datasets.  The
EuRoC functions import ``yaml`` when called, so the rest works without it.

Formats:
  EuRoC ASL  — ``mav0/cam{0,1}/data.csv`` (``timestamp_ns,filename``),
               ``mav0/cam{0,1}/data/*.png``, ``mav0/cam{0,1}/sensor.yaml``
               (``intrinsics: [fu,fv,cu,cv]``, ``resolution``, ``T_BS``),
               ``mav0/state_groundtruth_estimate0/data.csv``
               (ns, p_RS_R xyz, q_RS wxyz, ...).
  TUM RGB-D  — ``rgb.txt`` / ``depth.txt`` (``stamp filename``, ``#``
               comments), 16-bit depth PNGs at ``depth_scale`` (=5000)
               counts per meter, ``groundtruth.txt``
               (``stamp tx ty tz qx qy qz qw``).
"""

from __future__ import annotations

import csv
import dataclasses
import os
from typing import Optional

import numpy as np

# TUM freiburg3 pinhole intrinsics (the de-facto default when no
# calibration file accompanies a TUM-layout directory).
TUM_DEFAULT_INTRINSICS = (535.4, 539.2, 320.1, 247.6)
TUM_DEPTH_SCALE = 5000.0


@dataclasses.dataclass
class DatasetSequence:
    """Lazy on-disk sequence; images load per-frame via :meth:`frame`."""

    kind: str  # "euroc" | "tum"
    stamps: np.ndarray  # [T] seconds
    left_paths: list  # stereo left / rgb image paths
    right_paths: list  # stereo right / depth image paths
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    baseline: float = 0.0  # stereo only
    depth_scale: float = TUM_DEPTH_SCALE  # rgbd only
    gt_stamps: Optional[np.ndarray] = None  # [G]
    gt_poses: Optional[np.ndarray] = None  # [G, 4, 4] world_T_body
    t_bs: Optional[np.ndarray] = None  # [4, 4] body_T_cam0 (EuRoC T_BS)

    def __len__(self):
        return len(self.stamps)

    def frame(self, i):
        """Load frame i -> (stamp, left/rgb float32 [H,W], right float32
        [H,W] or depth-in-meters float32 [H,W])."""
        left = _load_gray(self.left_paths[i])
        if self.kind == "tum":
            right = _load_depth(self.right_paths[i], self.depth_scale)
        else:
            right = _load_gray(self.right_paths[i])
        return float(self.stamps[i]), left, right

    def frames(self):
        for i in range(len(self)):
            yield self.frame(i)

    def gt_at(self, stamps):
        """Interpolated ground-truth translations at the given stamps
        ([T, 4, 4]; nearest-sample rotation, lerped translation)."""
        assert self.gt_poses is not None, "sequence has no ground truth"
        out = np.tile(np.eye(4, dtype=np.float64), (len(stamps), 1, 1))
        g = self.gt_stamps
        for k, s in enumerate(np.asarray(stamps, np.float64)):
            j = int(np.clip(np.searchsorted(g, s), 1, len(g) - 1))
            a = float(np.clip((s - g[j - 1]) / max(g[j] - g[j - 1], 1e-9),
                              0.0, 1.0))
            out[k] = self.gt_poses[j] if a > 0.5 else self.gt_poses[j - 1]
            out[k, :3, 3] = ((1 - a) * self.gt_poses[j - 1][:3, 3]
                             + a * self.gt_poses[j][:3, 3])
        return out


# ---------------------------------------------------------------------------
# image IO (PIL; no OpenCV in the stack)
# ---------------------------------------------------------------------------


def _load_gray(path) -> np.ndarray:
    from PIL import Image

    img = Image.open(path)
    if img.mode not in ("L", "I;16", "I"):
        img = img.convert("L")
    arr = np.asarray(img)
    if arr.dtype != np.uint8:  # 16-bit gray: scale down
        arr = (arr.astype(np.float32) / 256.0).astype(np.float32)
        return arr
    return arr.astype(np.float32)


def _load_depth(path, depth_scale) -> np.ndarray:
    from PIL import Image

    arr = np.asarray(Image.open(path))
    return arr.astype(np.float32) / float(depth_scale)


def _save_gray(path, img):
    from PIL import Image

    Image.fromarray(
        np.clip(np.asarray(img), 0, 255).astype(np.uint8), mode="L"
    ).save(path)


def _save_depth(path, depth_m, depth_scale):
    from PIL import Image

    counts = np.clip(
        np.asarray(depth_m, np.float64) * depth_scale, 0, 65535
    ).astype(np.uint16)
    Image.fromarray(counts).save(path)


def _quat_wxyz_to_mat(qw, qx, qy, qz):
    n = max(np.sqrt(qw * qw + qx * qx + qy * qy + qz * qz), 1e-12)
    qw, qx, qy, qz = qw / n, qx / n, qy / n, qz / n
    return np.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz),
         2 * (qx * qz + qw * qy)],
        [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz),
         2 * (qy * qz - qw * qx)],
        [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx),
         1 - 2 * (qx * qx + qy * qy)],
    ])


def _mat_to_quat_wxyz(R):
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                         (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
    q = np.zeros(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


# ---------------------------------------------------------------------------
# EuRoC ASL
# ---------------------------------------------------------------------------


def read_euroc(root, cam0="cam0", cam1="cam1") -> DatasetSequence:
    """Read a EuRoC-ASL directory (`root` contains ``mav0/``, or IS mav0)."""
    import yaml

    mav = os.path.join(root, "mav0")
    if not os.path.isdir(mav):
        mav = root

    def read_cam(name):
        with open(os.path.join(mav, name, "sensor.yaml")) as f:
            sensor = yaml.safe_load(f)
        rows = []
        with open(os.path.join(mav, name, "data.csv")) as f:
            for row in csv.reader(f):
                if not row or row[0].lstrip().startswith("#"):
                    continue
                rows.append((int(row[0]),
                             os.path.join(mav, name, "data", row[1].strip())))
        return sensor, rows

    s0, rows0 = read_cam(cam0)
    s1, rows1 = read_cam(cam1)
    fu, fv, cu, cv = s0["intrinsics"]
    width, height = s0["resolution"]
    t_bs = np.asarray(s0["T_BS"]["data"], np.float64).reshape(4, 4)
    t_bs1 = np.asarray(s1["T_BS"]["data"], np.float64).reshape(4, 4)
    # stereo baseline = |cam0 -> cam1 translation|
    baseline = float(np.linalg.norm(
        (np.linalg.inv(t_bs) @ t_bs1)[:3, 3]
    ))

    # align the two streams on common timestamps
    by_ts1 = dict(rows1)
    stamps, lp, rp = [], [], []
    for ts, path in rows0:
        if ts in by_ts1:
            stamps.append(ts * 1e-9)
            lp.append(path)
            rp.append(by_ts1[ts])

    gt_stamps = gt_poses = None
    gt_csv = os.path.join(mav, "state_groundtruth_estimate0", "data.csv")
    if os.path.exists(gt_csv):
        ts_l, pose_l = [], []
        with open(gt_csv) as f:
            for row in csv.reader(f):
                if not row or row[0].lstrip().startswith("#"):
                    continue
                vals = [float(v) for v in row[:8]]
                T = np.eye(4)
                T[:3, :3] = _quat_wxyz_to_mat(*vals[4:8])
                T[:3, 3] = vals[1:4]
                ts_l.append(vals[0] * 1e-9)
                pose_l.append(T)
        gt_stamps = np.asarray(ts_l)
        gt_poses = np.stack(pose_l)

    return DatasetSequence(
        kind="euroc", stamps=np.asarray(stamps), left_paths=lp,
        right_paths=rp, fx=float(fu), fy=float(fv), cx=float(cu),
        cy=float(cv), width=int(width), height=int(height),
        baseline=baseline, gt_stamps=gt_stamps, gt_poses=gt_poses,
        t_bs=t_bs,
    )


def _host(x) -> np.ndarray:
    """A camera field (a tensor on any device) as a float64 numpy array."""
    return np.asarray(x.cpu() if hasattr(x, "cpu") else x, np.float64)


def write_euroc(seq, root):
    """Write a :class:`visfs_tpu_torch.io.sim.SimSequence` as a EuRoC-ASL
    tree."""
    import yaml

    cam = seq.camera
    t_ri = _host(cam.t_ri)  # image(cam0) -> robot = T_BS
    t_bs1 = t_ri.copy()
    # cam1 sits +baseline along cam0 x (right camera)
    t_bs1[:3, 3] += t_ri[:3, :3] @ np.array([float(cam.baseline), 0, 0])
    for name, t_bs, images in (("cam0", t_ri, seq.left),
                               ("cam1", t_bs1, seq.right)):
        d = os.path.join(root, "mav0", name, "data")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(root, "mav0", name, "sensor.yaml"), "w") as f:
            yaml.safe_dump(
                {
                    "sensor_type": "camera",
                    "camera_model": "pinhole",
                    "intrinsics": [float(cam.fx), float(cam.fy),
                                   float(cam.cx), float(cam.cy)],
                    "resolution": [int(cam.width), int(cam.height)],
                    "distortion_model": "radial-tangential",
                    "distortion_coefficients": [0.0, 0.0, 0.0, 0.0],
                    "T_BS": {"rows": 4, "cols": 4,
                             "data": [float(v) for v in t_bs.ravel()]},
                },
                f,
            )
        with open(os.path.join(root, "mav0", name, "data.csv"), "w") as f:
            f.write("#timestamp [ns],filename\n")
            for ts, img in zip(seq.stamps, images):
                ns = int(round(ts * 1e9))
                fname = f"{ns}.png"
                _save_gray(os.path.join(d, fname), img)
                f.write(f"{ns},{fname}\n")

    gdir = os.path.join(root, "mav0", "state_groundtruth_estimate0")
    os.makedirs(gdir, exist_ok=True)
    with open(os.path.join(gdir, "data.csv"), "w") as f:
        f.write("#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m],"
                " q_RS_w [], q_RS_x [], q_RS_y [], q_RS_z []\n")
        for ts, T in zip(seq.stamps, seq.poses):
            q = _mat_to_quat_wxyz(np.asarray(T)[:3, :3])
            p = np.asarray(T)[:3, 3]
            f.write(f"{int(round(ts * 1e9))},{p[0]},{p[1]},{p[2]},"
                    f"{q[0]},{q[1]},{q[2]},{q[3]}\n")


# ---------------------------------------------------------------------------
# TUM RGB-D
# ---------------------------------------------------------------------------


def _read_tum_list(path):
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            rows.append((float(parts[0]), parts[1:]))
    return rows


def associate(a_stamps, b_stamps, max_difference=0.02):
    """Greedy nearest-stamp association (the TUM associate.py algorithm):
    best-first over all |ta - tb| <= max_difference, each index used once.
    Returns list of (ia, ib)."""
    cands = []
    j0 = 0
    b = np.asarray(b_stamps)
    for i, ta in enumerate(a_stamps):
        j = int(np.clip(np.searchsorted(b, ta), 0, len(b) - 1))
        for k in (j - 1, j, j + 1):
            if 0 <= k < len(b) and abs(ta - b[k]) <= max_difference:
                cands.append((abs(ta - b[k]), i, k))
    cands.sort()
    used_a, used_b, out = set(), set(), []
    for _, i, k in cands:
        if i not in used_a and k not in used_b:
            used_a.add(i)
            used_b.add(k)
            out.append((i, k))
    out.sort()
    return out


def read_tum_rgbd(root, intrinsics=None, depth_scale=TUM_DEPTH_SCALE,
                  max_difference=0.02) -> DatasetSequence:
    """Read a TUM-RGBD directory (rgb.txt/depth.txt/groundtruth.txt).

    ``intrinsics``: (fx, fy, cx, cy); if None, a ``calibration.txt`` with
    one ``fx fy cx cy`` line is honored, else the freiburg3 defaults.
    """
    rgb = _read_tum_list(os.path.join(root, "rgb.txt"))
    depth = _read_tum_list(os.path.join(root, "depth.txt"))
    pairs = associate([r[0] for r in rgb], [d[0] for d in depth],
                      max_difference)
    if intrinsics is None:
        calib = os.path.join(root, "calibration.txt")
        if os.path.exists(calib):
            with open(calib) as f:
                vals = [float(v) for v in f.read().split()[:4]]
            intrinsics = tuple(vals)
        else:
            intrinsics = TUM_DEFAULT_INTRINSICS
    fx, fy, cx, cy = intrinsics

    stamps, lp, rp = [], [], []
    for i, k in pairs:
        stamps.append(rgb[i][0])
        lp.append(os.path.join(root, rgb[i][1][0]))
        rp.append(os.path.join(root, depth[k][1][0]))

    gt_stamps = gt_poses = None
    gt_txt = os.path.join(root, "groundtruth.txt")
    if os.path.exists(gt_txt):
        ts_l, pose_l = [], []
        for ts, vals in _read_tum_list(gt_txt):
            tx, ty, tz, qx, qy, qz, qw = [float(v) for v in vals[:7]]
            T = np.eye(4)
            T[:3, :3] = _quat_wxyz_to_mat(qw, qx, qy, qz)
            T[:3, 3] = (tx, ty, tz)
            ts_l.append(ts)
            pose_l.append(T)
        gt_stamps = np.asarray(ts_l)
        gt_poses = np.stack(pose_l)

    # probe resolution from the first image
    if lp:
        from PIL import Image

        with Image.open(lp[0]) as im:
            width, height = im.size
    else:
        width = height = 0

    return DatasetSequence(
        kind="tum", stamps=np.asarray(stamps), left_paths=lp, right_paths=rp,
        fx=float(fx), fy=float(fy), cx=float(cx), cy=float(cy),
        width=width, height=height, depth_scale=depth_scale,
        gt_stamps=gt_stamps, gt_poses=gt_poses,
    )


def write_tum_rgbd(seq, root, depth_scale=TUM_DEPTH_SCALE):
    """Write a SimSequence (generated ``with_depth=True``) as TUM-RGBD."""
    assert seq.depth is not None, "SimSequence needs with_depth=True"
    cam = seq.camera
    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    with open(os.path.join(root, "calibration.txt"), "w") as f:
        f.write(f"{float(cam.fx)} {float(cam.fy)} "
                f"{float(cam.cx)} {float(cam.cy)}\n")
    with open(os.path.join(root, "rgb.txt"), "w") as frgb, \
            open(os.path.join(root, "depth.txt"), "w") as fdep:
        frgb.write("# color images\n# timestamp filename\n")
        fdep.write("# depth images\n# timestamp filename\n")
        for ts, img, dep in zip(seq.stamps, seq.left, seq.depth):
            name = f"{ts:.6f}.png"
            _save_gray(os.path.join(root, "rgb", name), img)
            _save_depth(os.path.join(root, "depth", name), dep, depth_scale)
            frgb.write(f"{ts:.6f} rgb/{name}\n")
            fdep.write(f"{ts:.6f} depth/{name}\n")
    with open(os.path.join(root, "groundtruth.txt"), "w") as f:
        f.write("# ground truth trajectory\n# timestamp tx ty tz qx qy qz qw\n")
        for ts, T in zip(seq.stamps, seq.poses):
            q = _mat_to_quat_wxyz(np.asarray(T)[:3, :3])
            p = np.asarray(T)[:3, 3]
            f.write(f"{ts:.6f} {p[0]} {p[1]} {p[2]} "
                    f"{q[1]} {q[2]} {q[3]} {q[0]}\n")
