"""ctypes bindings for the native runtime (torch port of visfs_tpu.runtime).

``runtime.cc`` beside this file is built with g++ at first use into
``build/visfs_tpu_torch/`` (``ops/kernels/_build.py``, under a hash of the
source and flags) and loaded by ``ctypes.CDLL``, whose calls release the
GIL, so ``stop`` can join a worker that is inside the step.  A failed build
raises.  ``PipelineRuntime`` wraps ingest + approx-time sync + the worker
thread; ``SystemRuntime`` composes it with a slam.system.System for a full
native-fed pipeline (the reference's InterfaceROS + System thread stack).

The worker thread calls the System with host numpy arrays copied out of the
C++ queue; ``System.input_primary_sensor_data`` moves them to the device
through pinned memory without waiting for it, and serialises its state
updates with the wheel-odometry rows that other threads push meanwhile.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Callable

import numpy as np

from ..ops.kernels._build import load_library as _load

LIB_NAME = "visfs_runtime"
_SOURCES = ("runtime.cc",)

_STEP_CB = ctypes.CFUNCTYPE(
    None, ctypes.c_uint64, ctypes.c_double,
    ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
    ctypes.c_int, ctypes.c_int,
    ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_void_p,
)


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the runtime library; returns it."""
    lib = _load(LIB_NAME, _SOURCES, src_dir=Path(__file__).parent,
                compiler="g++")
    if lib.visfs_rt_create.argtypes is not None:
        return lib
    lib.visfs_rt_create.restype = ctypes.c_void_p
    lib.visfs_rt_create.argtypes = [ctypes.c_int, ctypes.c_double,
                                    ctypes.c_int]
    lib.visfs_rt_destroy.argtypes = [ctypes.c_void_p]
    for name in ("visfs_rt_push_left", "visfs_rt_push_right"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_double,
                       ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                       ctypes.c_int]
    lib.visfs_rt_push_scan.argtypes = [
        ctypes.c_void_p, ctypes.c_double, ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
    ]
    lib.visfs_rt_poll.restype = ctypes.c_int
    lib.visfs_rt_poll.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.visfs_rt_start.argtypes = [ctypes.c_void_p, _STEP_CB,
                                   ctypes.c_void_p]
    lib.visfs_rt_stop.argtypes = [ctypes.c_void_p]
    lib.visfs_rt_queue_depth.restype = ctypes.c_int
    lib.visfs_rt_queue_depth.argtypes = [ctypes.c_void_p]
    lib.visfs_rt_stats.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_uint64)]
    return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class PipelineRuntime:
    """Native ingest + approx-time sync + optional worker thread."""

    def __init__(self, height: int, width: int, capacity: int = 8,
                 slop_s: float = 0.01, with_scan: bool = False,
                 max_scan_points: int = 1024):
        self._lib = load_library()
        self._h = self._lib.visfs_rt_create(capacity, slop_s,
                                            1 if with_scan else 0)
        self.height = height
        self.width = width
        self.max_scan_points = max_scan_points
        self._cb_keepalive = None

    def close(self):
        if self._h:
            self._lib.visfs_rt_stop(self._h)
            self._lib.visfs_rt_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def push_left(self, stamp: float, img: np.ndarray):
        img = np.ascontiguousarray(img, dtype=np.float32)
        self._lib.visfs_rt_push_left(self._h, stamp, _fptr(img),
                                     img.shape[0], img.shape[1])

    def push_right(self, stamp: float, img: np.ndarray):
        img = np.ascontiguousarray(img, dtype=np.float32)
        self._lib.visfs_rt_push_right(self._h, stamp, _fptr(img),
                                      img.shape[0], img.shape[1])

    def push_scan(self, stamp: float, points: np.ndarray):
        points = np.ascontiguousarray(points, dtype=np.float32)
        self._lib.visfs_rt_push_scan(self._h, stamp, _fptr(points),
                                     points.shape[0])

    def poll(self, timeout_ms: int = 0):
        """Pop one synced frame -> (stamp, id, left, right, scan|None)."""
        left = np.empty((self.height, self.width), np.float32)
        right = np.empty((self.height, self.width), np.float32)
        scan = np.empty((self.max_scan_points, 3), np.float32)
        stamp = ctypes.c_double()
        fid = ctypes.c_uint64()
        nsc = ctypes.c_int()
        r = self._lib.visfs_rt_poll(
            self._h, timeout_ms, ctypes.byref(stamp), ctypes.byref(fid),
            _fptr(left), _fptr(right), self.height, self.width,
            _fptr(scan), self.max_scan_points, ctypes.byref(nsc),
        )
        if r != 1:
            return None
        sc = scan[: nsc.value].copy() if nsc.value else None
        return stamp.value, fid.value, left, right, sc

    def start(self, on_frame: Callable):
        """Run the worker thread; on_frame(stamp, left, right, scan|None)."""

        def _cb(fid, stamp, lp, rp, rows, cols, sp, n_scan, _user):
            left = np.ctypeslib.as_array(lp, shape=(rows, cols)).copy()
            right = np.ctypeslib.as_array(rp, shape=(rows, cols)).copy()
            scan = (
                np.ctypeslib.as_array(sp, shape=(n_scan, 3)).copy()
                if n_scan else None
            )
            on_frame(stamp, left, right, scan)

        self._cb_keepalive = _STEP_CB(_cb)
        self._lib.visfs_rt_start(self._h, self._cb_keepalive, None)

    def stop(self):
        self._lib.visfs_rt_stop(self._h)

    def queue_depth(self) -> int:
        return self._lib.visfs_rt_queue_depth(self._h)

    def stats(self) -> dict:
        buf = (ctypes.c_uint64 * 8)()
        self._lib.visfs_rt_stats(self._h, buf)
        return {
            "pushed_left": buf[0], "pushed_right": buf[1],
            "pushed_scan": buf[2], "synced": buf[3],
            "dropped_unmatched": buf[4], "dropped_overflow": buf[5],
            "processed": buf[6], "last_latency_ms": buf[7] / 1000.0,
        }


class SystemRuntime:
    """Native-fed System: sensors stream in, odometry streams out."""

    def __init__(self, system, capacity: int = 8, slop_s: float = 0.01):
        if system.camera is None:
            raise RuntimeError("SystemRuntime: call System.init() first")
        self.system = system
        self.rt = PipelineRuntime(
            system.camera.height, system.camera.width, capacity, slop_s,
            with_scan=system.cfg.system_sensor_strategy >= 3,
        )
        # exceptions the worker's steps raised: a ctypes callback cannot
        # pass them on (ctypes prints them), so the caller reads them here
        self.errors: list = []

    def start(self):
        def on_frame(stamp, left, right, scan):
            try:
                self.system.input_primary_sensor_data(stamp, left, right,
                                                      scan=scan)
            except BaseException as e:
                self.errors.append(e)
                raise

        self.rt.start(on_frame)

    def stop(self):
        self.rt.stop()

    push_left = property(lambda self: self.rt.push_left)
    push_right = property(lambda self: self.rt.push_right)
    push_scan = property(lambda self: self.rt.push_scan)
    push_odometry = property(
        lambda self: self.system.input_wheel_odometry
    )

    def output(self):
        return self.system.output_odometry_info()

    def stats(self):
        return self.rt.stats()
