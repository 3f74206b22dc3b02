"""Share of its roofline the predict path's MLP kernel reaches a launch,
against ``portbench/work.py``'s bound at a request's points."""

from portbench import work


def read(r):
    launches, seconds = r.kernel_times("mlp_fwd_kernel")
    if not launches:
        return None
    bound = work.bound_s(*work.mlp_forward(r.config, r.facts["points"]))
    return 100 * bound / (seconds / launches)
