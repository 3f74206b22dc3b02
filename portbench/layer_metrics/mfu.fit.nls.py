"""The whole training step's model FLOPs a second over the float32 peak,
for a chain from an embedding's state: steps in the traced window times
``portbench/work_embedded.py``'s FLOPs a step, over the same units'
untraced seconds."""

from portbench import work, work_embedded


def read(r):
    f = r.facts
    if not f.get("steps") or not r.untraced_s:
        return None
    flops = work_embedded.adam_step_flops(r.config, f["points"])
    return 100 * flops * f["steps"] / r.untraced_s / work.PEAK_F32_FLOPS
