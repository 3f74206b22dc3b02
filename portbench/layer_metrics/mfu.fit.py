"""The whole training step's model FLOPs a second over the float32 peak:
steps in the traced window times ``portbench/work.py``'s FLOPs a step
(Levenberg-Marquardt: at the live CG iterations the reference's CG takes on
the checked steps' inputs), over the same units' untraced seconds."""

from portbench import work


def read(r):
    f = r.facts
    if not f.get("steps") or not r.untraced_s:
        return None
    if f.get("step_kind") == "lm":
        if "live_cg_per_step" not in f:
            return None
        flops = work.lm_step_flops(r.config, f["points"],
                                   f["live_cg_per_step"])
    else:
        flops = work.adam_step_flops(r.config, f["points"])
    return 100 * flops * f["steps"] / r.untraced_s / work.PEAK_F32_FLOPS
