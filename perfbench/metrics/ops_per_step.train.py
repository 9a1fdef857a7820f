"""ops_per_step.train: the device operations that begin inside the train()
calls over the number of the port's df.adam spans in them: the plain
training program's launches a step, its per-epoch evaluation included
(routing, fold and kernel wrappers). None where no call holds a df.adam
span (a kernel path)."""

import bisect

from ._stages import calls

UNIT = "ops/step"


def read(sl):
    starts = [o[1] for o in sl.ops]
    n_ops = n_steps = 0
    for h, group in calls(sl, "train"):
        steps = sum(1 for s in group if s.name == "df.adam")
        if steps:
            n_steps += steps
            n_ops += (bisect.bisect_right(starts, h.end)
                      - bisect.bisect_left(starts, h.start))
    return n_ops / n_steps if n_steps else None
