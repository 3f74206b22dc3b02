"""Share of its roofline the Taylor backward reaches: its two kernels
(``taylor_bwd_kernel`` and the per-block partials' reduction) a launch,
against ``portbench/work.py``'s bound at the cell's points."""

from portbench import work


def read(r):
    launches, seconds = r.kernel_times("taylor_bwd_kernel")
    if not launches:
        return None
    _, reduce_s = r.kernel_times("reduce_partials_kernel")
    bound = work.bound_s(*work.taylor_backward(r.config, r.facts["points"]))
    return 100 * bound / ((seconds + reduce_s) / launches)
