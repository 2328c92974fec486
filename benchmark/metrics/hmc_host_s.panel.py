"""Host seconds a job spends inside run_hmc, where
inference.device_smc binds it."""

from ._shared import span_mean


def read(ctx):
    return span_mean(ctx, "hmc")
