"""Share of its roofline the Taylor backward reaches from an embedding's
input state: its two kernels (``taylor_bwd_kernel`` and the per-block
partials' reduction) a launch, against ``portbench/work_embedded.py``'s
bound at the cell's points."""

from portbench import work, work_embedded


def read(r):
    launches, seconds = r.kernel_times("taylor_bwd_kernel")
    if not launches:
        return None
    _, reduce_s = r.kernel_times("reduce_partials_kernel")
    bound = work.bound_s(*work_embedded.taylor_backward(r.config,
                                                        r.facts["points"]))
    return 100 * bound / ((seconds + reduce_s) / launches)
