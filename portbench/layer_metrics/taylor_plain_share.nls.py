"""The share of the window's fits' Taylor traversals that took the plain
traversal, in %: the ``taylor_plain`` attribute of the program's
``pydens.fit`` spans over ``taylor_kernels`` plus ``taylor_plain`` (a
step's traversals by route).  A program whose spans have no such
attributes gives nothing to read."""

from portbench.program_spans import spans


def read(r):
    fits = [s for s in spans(r, "pydens.fit")
            if "taylor_plain" in s.attrs and "taylor_kernels" in s.attrs]
    plain = sum(s.attrs["taylor_plain"] for s in fits)
    total = plain + sum(s.attrs["taylor_kernels"] for s in fits)
    if not total:
        return None
    return 100 * plain / total
