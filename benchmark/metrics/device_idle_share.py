"""device: the share of the unprofiled window in which the card ran
nothing, 1 - (device time a fleet frame, from the slice) x (frames) / (the
window's wall), in percent.  The wall comes from the window the profiler
did not slow."""


def read(r):
    if r.prof is None or r.prof.kernels == 0 or r.frames == 0:
        return None
    busy = r.prof.kernel_s / r.prof.frames * r.frames
    return {"value": 100.0 * (1.0 - busy / r.window_s), "unit": "%"}
