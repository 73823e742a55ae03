"""device: the summed device time of a fleet frame's operations in the
profiled slice, milliseconds."""


def read(r):
    if r.prof is None or r.prof.kernels == 0:
        return None
    return {"value": 1e3 * r.prof.kernel_s / r.prof.frames, "unit": "ms"}
