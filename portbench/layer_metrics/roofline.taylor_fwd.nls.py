"""Share of its roofline the Taylor forward kernel reaches from an
embedding's input state: the least time ``portbench/work_embedded.py``
allows a launch at the cell's points, over the kernel's mean time a launch
in the trace (none where the chain takes the plain traversal)."""

from portbench import work, work_embedded


def read(r):
    launches, seconds = r.kernel_times("taylor_fwd_kernel")
    if not launches:
        return None
    bound = work.bound_s(*work_embedded.taylor_forward(r.config,
                                                       r.facts["points"]))
    return 100 * bound / (seconds / launches)
