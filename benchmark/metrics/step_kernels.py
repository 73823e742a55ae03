"""step: device operations a fleet frame in the profiled slice (the
profiler's CUDA events, as chip_smoke.py's device_kernels counts them)."""


def read(r):
    if r.prof is None or r.prof.kernels == 0:
        return None
    return {"value": r.prof.kernels / r.prof.frames, "unit": "kernels"}
