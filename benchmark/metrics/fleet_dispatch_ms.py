"""fleet API: the host's milliseconds in
``FleetSystem.input_primary_sensor_data`` a fleet frame, the mean over the
unprofiled window (a span around the call, in the harness)."""


def read(r):
    if not r.dispatch_s:
        return None
    return {"value": 1e3 * sum(r.dispatch_s) / len(r.dispatch_s),
            "unit": "ms"}
