"""Share of its roofline the Taylor forward kernel reaches: the least time
``portbench/work.py`` allows a launch at the cell's points, over the
kernel's mean time a launch in the trace."""

from portbench import work


def read(r):
    launches, seconds = r.kernel_times("taylor_fwd_kernel")
    if not launches:
        return None
    bound = work.bound_s(*work.taylor_forward(r.config, r.facts["points"]))
    return 100 * bound / (seconds / launches)
