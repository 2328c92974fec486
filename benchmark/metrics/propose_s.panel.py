"""Host seconds a job spends in the program's mcmc/device_propose spans:
the device tree surgery and the proposal's value and gradient, queued."""

from ._shared import span_mean


def read(ctx):
    return span_mean(ctx, "mcmc/device_propose")
