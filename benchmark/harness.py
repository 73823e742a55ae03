"""One run of one cell: set-up, the measured window, the traced slice, the
comparison.  ``run.py`` is the command; this module takes a device so that
the CPU tests can drive a whole run at a small size.

The system under test is ``visfs_tpu_torch.slam.fleet.FleetSystem``: the
window feeds it one fleet frame at a time through
``input_primary_sensor_data`` (the vmapped ``vo_step``) and takes each
frame's outputs with ``output_odometry_info`` one frame behind, so at most
two fleet frames are in flight, as a fleet server publishes them.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import subprocess
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from . import check, scene, trace

ROOT = Path(__file__).resolve().parent
# Estimator/MinInliers at its registry default: a frame whose BA kept fewer
# inliers takes the PnP pose, which the BA check does not judge.
MIN_INLIERS = 12
# Fixed directory inside the checkout for the noise-free lap renders.
SCENE_CACHE = ROOT.parent / "build" / "benchmark" / "scene"


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """A workload of BENCHMARK.json with its files read."""

    name: str
    config: dict
    traffic: dict
    limits: dict
    per_layer: list  # the per-layer metric names this cell reports

    @classmethod
    def load(cls, bench: dict, name: str, root: Path = ROOT.parent):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                             f"{sorted(cells)}")
        w = cells[name]
        cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
        per_layer = [m["name"] for m in bench["per_layer"]
                     if name in m.get("workloads", [name])]
        return cls(name=name, config=load_json(root / cfg_entry["file"]),
                   traffic=load_json(ROOT / "traffic"
                                     / f"{w['traffic']}.json"),
                   limits=load_json(ROOT / "limits" / f"{name}.json"),
                   per_layer=per_layer)


def stream_offsets(seed: int, n_streams: int, starts: np.ndarray
                   ) -> np.ndarray:
    """Stream k's start frame: evenly spread over the allowed ``starts``
    (the same set for every seed), rotated within them and shuffled by the
    seed."""
    rng = np.random.default_rng(seed)
    m = len(starts)
    base = (np.arange(n_streams) * m) // n_streams
    shift = int(rng.integers(m))
    return starts[(base + shift) % m][rng.permutation(n_streams)]


def _process_age_s() -> float:
    """Seconds since this process started (Linux: its start tick)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    return (time.clock_gettime(time.CLOCK_BOOTTIME)
            - start_ticks / os.sysconf("SC_CLK_TCK"))


def power_limit() -> Optional[str]:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None


class Fleet:
    """The fleet under test and the lap it runs round."""

    def __init__(self, cell: Cell, seed: int, device, streams=None):
        from visfs_tpu_torch.slam.fleet import FleetSystem

        cfg, tr = cell.config, cell.traffic
        sc = tr["scene"]
        self.device = torch.device(device)
        self.B = int(streams or tr["streams"])
        width, height = cfg["width"], cfg["height"]
        n_lap, speed = scene.lap_frames(tuple(sc["room"]), sc["frame_step_m"])
        self.lap = scene.lap_geometry(
            n_lap, speed, width, height, world_seed=sc["world_seed"],
            room=tuple(sc["room"]), z_floor=sc["z_floor"],
            z_ceil=sc["z_ceil"], n_pillars=sc["n_pillars"], fps=sc["fps"])
        key = dict(sc, width=width, height=height, frames=n_lap)
        self.parts = {"imports": _process_age_s()}
        views = scene.lap_views(self.lap, self.device, str(SCENE_CACHE), key)
        self.images = scene.lap_images(views, seed, sc["pixel_noise"],
                                       sc["exposure_drift"])
        del views
        self.parts["lap"] = _process_age_s() - self.parts["imports"]
        self.fps = sc["fps"]
        self.offsets = stream_offsets(seed, self.B, scene.straight_starts(
            tuple(sc["room"]), n_lap, speed, sc["fps"],
            tr["start_lead_frames"]))
        self.offsets_dev = torch.as_tensor(self.offsets, device=self.device)
        cam = self.lap.camera
        self.fleet = FleetSystem(cfg["parameters"], n_streams=self.B,
                                 device=self.device, seed=seed % (2 ** 31))
        self.fleet.init(cam.fx, cam.fy, cam.cx, cam.cy, cam.baseline,
                        width=width, height=height)
        self.parts["fleet_init"] = (_process_age_s() - self.parts["lap"]
                                    - self.parts["imports"])
        rng = np.random.default_rng([seed, 1])
        n_check = min(self.B, tr["check"]["streams"])
        self.checked = np.sort(rng.choice(self.B, n_check, replace=False))
        self.checked_dev = torch.as_tensor(self.checked, device=self.device)
        self.n = 0  # frames fed so far, per stream
        self.snaps = []
        self.poses, self.lost, self.counts, self.ba_used = [], [], [], []

    def feed(self) -> float:
        """Feed the next fleet frame; returns the host's seconds in
        ``input_primary_sensor_data``."""
        idx = (self.offsets_dev + self.n) % self.images.shape[0]
        lefts = self.images[idx, 0]
        rights = self.images[idx, 1]
        stamps = torch.full((self.B,), self.n / self.fps, device=self.device)
        h0 = time.perf_counter()
        self.fleet.input_primary_sensor_data(stamps, lefts, rights)
        h1 = time.perf_counter()
        self.snaps.append(self._snapshot())
        self.n += 1
        return h1 - h0

    def _snapshot(self) -> dict:
        """The checked streams' feature tables after the step just fed, as
        the comparison needs them (device copies)."""
        f = self.fleet.states.features
        sel = self.checked_dev
        W = f.uv.shape[2]
        obs = f.obs_mask.index_select(0, sel)
        return {
            "uv": f.uv.index_select(0, sel)[:, :, W - 2:],
            "obs": obs[:, :, W - 2:] & f.valid.index_select(0, sel)[:, :, None],
            "uvr": f.uv_right.index_select(0, sel)[:, :, W - 1],
            "depth": f.depth.index_select(0, sel)[:, :, W - 1],
            "pw": f.pw.index_select(0, sel),
            "landmark": obs.sum(-1) >= 2,
            "window_full": torch.all(
                self.fleet.states.window.valid.index_select(0, sel), dim=-1),
        }

    def take(self) -> None:
        """Wait for the oldest fleet frame in flight and keep its poses and
        lost flags on the host (and its feature counts)."""
        out = self.fleet.output_odometry_info()
        self.poses.append(np.asarray(out.pose))
        self.lost.append(np.asarray(out.lost, bool))
        self.counts.append((np.asarray(out.n_features),
                            np.asarray(out.n_new)))
        self.ba_used.append(np.asarray(out.ba_ok, bool)
                            & (np.asarray(out.n_inliers) >= MIN_INLIERS))


def _reader(name: str) -> Callable:
    return importlib.import_module(f"benchmark.metrics.{name}").read


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device,
             *, streams=None, keep_record=False, min_frames=0) -> dict:
    """One run: returns the result's fields (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, ``compared``, ``check_s``, maybe
    ``breakdown``); with ``keep_record`` also the comparison's input
    (``record``).  The window lasts ``seconds`` and, for the CPU tests'
    small runs, at least ``min_frames`` fleet frames."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tr = cell.traffic
    fl = Fleet(cell, seed, device, streams=streams)
    is_cuda = fl.device.type == "cuda"

    def sync():
        if is_cuda:
            torch.cuda.synchronize(fl.device)

    for _ in range(tr["warmup_frames"]):
        fl.feed()
        fl.take()
    sync()
    setup_s = _process_age_s()
    fl.parts["warmup"] = setup_s - sum(fl.parts.values())

    # The measured window: feed frame n, then take frame n - 1.
    dispatch = []
    t0 = time.perf_counter()
    dispatch.append(fl.feed())
    taken_in_window = 0
    t_end = t0
    while True:
        dispatch.append(fl.feed())
        fl.take()
        t_end = time.perf_counter()
        taken_in_window += 1
        if t_end - t0 >= seconds and taken_in_window >= min_frames:
            break
    window_frames = range(tr["warmup_frames"], fl.n)
    fl.take()  # the frame still in flight: judged, not counted
    sync()
    window_s = t_end - t0
    rate = taken_in_window * fl.B / window_s

    prof = None
    if traced:
        prof = trace.profile_slice(fl, tr["profile_frames"], sync)
    peak = (torch.cuda.max_memory_allocated(fl.device) if is_cuda else 0)

    rec = check.Record(
        images=fl.images, lap=fl.lap, offsets=fl.offsets,
        ref=cell.config["reference"], poses=np.stack(fl.poses),
        lost=np.stack(fl.lost), ba_used=np.stack(fl.ba_used),
        window_frames=window_frames, checked=fl.checked,
        snaps=fl.snaps[window_frames.start - 1:window_frames.stop],
        span=tr["check"]["span_frames"])
    counts = fl.counts
    del fl.fleet  # the program's state goes before the reference runs
    if is_cuda:
        torch.cuda.empty_cache()
    c0 = time.perf_counter()
    correct, compared = check.judge(check.numbers(rec), cell.limits)
    result = {
        "correct": correct,
        "attempted": len(window_frames) * fl.B,
        "failed": int(rec.lost[list(window_frames)].sum()),
        "device": _device(fl.device, peak),
        "compared": compared,
        "check_s": time.perf_counter() - c0,
        "setup_parts": fl.parts,
    }
    if keep_record:
        result["record"] = rec
    if not traced:
        result["metrics"] = {
            "stream_frames_per_s": {"value": rate, "unit": "frames/s"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
        return result
    readings = trace.Readings(
        dispatch_s=dispatch, window_s=window_s, frames=taken_in_window,
        prof=prof, counts=counts, config=cell.config,
        levels=cell.config["reference"]["levels"],
        win=cell.config["reference"]["win"])
    metrics = {}
    for name in cell.per_layer:
        got = _reader(name)(readings)
        if got is not None:
            metrics[name] = got
    result["metrics"] = metrics
    if is_cuda:
        # beside k1_roofline_share: the peaks assume the card's full 700 W
        result["device"]["power_limit"] = power_limit()
    if prof is not None:
        result["device"]["busy_s"] = prof.busy_s
        result["device"]["window_s"] = prof.window_s
        result["breakdown"] = prof.breakdown
    return result


def _device(device, peak) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(peak)}
