"""Device operations a fit step inside the solves of the traced window:
the records within the benchmark's ``portbench.fit`` spans, over the
steps."""


def read(r):
    fits = [s for s in r.spans if s[0] == "portbench.fit"]
    steps = r.facts.get("steps")
    if not fits or not steps:
        return None
    ops = sum(len(r.within(s)) for s in fits)
    return ops / steps if ops else None
