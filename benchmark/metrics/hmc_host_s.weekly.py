"""Host seconds a job spends inside run_hmc, where inference.structure_mcmc
and models.gp_model bind it."""

from ._shared import span_mean


def read(ctx):
    return span_mean(ctx, "hmc")
