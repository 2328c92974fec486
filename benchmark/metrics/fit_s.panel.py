"""Host seconds a job spends fitting its panel: the span around
fit_panel, ending in a synchronise."""

from ._shared import span_mean


def read(ctx):
    return span_mean(ctx, "fit")
