"""Device time of the copies to the card and back (``Memcpy`` records), a
request."""


def read(r):
    n = r.facts.get("requests")
    if not n:
        return None
    copies, seconds = r.kernel_times("Memcpy")
    return 1e3 * seconds / n if copies else None
