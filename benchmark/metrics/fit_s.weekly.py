"""Host seconds a job spends fitting: the span around make_and_fit_model,
ending in a synchronise."""

from ._shared import span_mean


def read(ctx):
    return span_mean(ctx, "fit")
