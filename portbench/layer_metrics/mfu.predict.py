"""A request's model FLOPs (the network over its points) a second over the
float32 peak, across the traced requests' untraced seconds."""

from portbench import work


def read(r):
    n = r.facts.get("requests")
    if not n or not r.untraced_s:
        return None
    flops = work.predict_flops(r.config, r.facts["points"])
    return 100 * flops * n / r.untraced_s / work.PEAK_F32_FLOPS
