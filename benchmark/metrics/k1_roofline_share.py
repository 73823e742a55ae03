"""K1: the least time K1's work could take on the card (roofline.py, the
work counted from the slice's own feature counts as a lower bound) over
K1's device time in the profiled slice, in percent."""

from benchmark import roofline


def read(r):
    if r.prof is None or r.prof.k1_launches == 0 or r.prof.k1_s <= 0:
        return None
    bidirectional = bool(r.config["parameters"].get("Tracker/FlowBack",
                                                    True))
    flops = 0
    for n_features, n_new in r.counts[-r.prof.frames:]:
        for nf, nn in zip(n_features.tolist(), n_new.tolist()):
            flops += roofline.k1_least_flops(int(nf), int(nn), r.levels,
                                             r.win, bidirectional)
    least = roofline.bound_s(0.0, flops)
    return {"value": 100.0 * least / r.prof.k1_s, "unit": "%"}
