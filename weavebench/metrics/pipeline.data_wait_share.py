"""Share of the window's step time the trainer waited on the staging ring
(``StepTiming.data_wait_s``, the loop's ``pipeline.data_wait`` span), over
the steps outside the traced slice."""


def read(run):
    steps = [t for i, t in enumerate(run.timings)
             if not (run.profiled and run.profiled[0] <= i < run.profiled[1])]
    wall = sum(t.wall_s for t in steps)
    if not steps or wall <= 0:
        return None
    return 100.0 * sum(t.data_wait_s for t in steps) / wall
