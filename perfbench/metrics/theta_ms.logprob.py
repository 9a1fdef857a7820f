"""theta_ms.logprob: the mean over log_prob calls of the self time of the
port's df.theta span: x and θ brought to float32 on the device, θ broadcast and
normalized (entry points)."""

from ._stages import stage_ms

UNIT = "ms"


def read(sl):
    return stage_ms(sl, "log_prob", ("df.theta",))
