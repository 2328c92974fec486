"""Host seconds a job spends inside propose_batch, where
inference.structure_mcmc binds it."""

from ._shared import span_mean


def read(ctx):
    return span_mean(ctx, "propose")
