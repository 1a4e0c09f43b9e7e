"""The whole step's share of the chip's bf16 peak: model FLOPs a step
(``run.step_flops``, from ``step_model_flops`` of the reference module the
configuration names, ``wb/reference/<reference>.py``) times the steps, over
their wall seconds, outside the traced slice."""


def read(run):
    steps = [t for i, t in enumerate(run.timings)
             if not (run.profiled and run.profiled[0] <= i < run.profiled[1])]
    wall = sum(t.wall_s for t in steps)
    if not steps or wall <= 0:
        return None
    return 100.0 * run.step_flops * len(steps) / wall / run.peaks["bf16_flops_per_s"]
