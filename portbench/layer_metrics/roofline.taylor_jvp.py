"""Share of its roofline the tangent kernel (Levenberg-Marquardt's
``J v``) reaches a launch, against ``portbench/work.py``'s bound."""

from portbench import work


def read(r):
    launches, seconds = r.kernel_times("taylor_jvp_kernel")
    if not launches:
        return None
    bound = work.bound_s(*work.taylor_jvp(r.config, r.facts["points"]))
    return 100 * bound / (seconds / launches)
