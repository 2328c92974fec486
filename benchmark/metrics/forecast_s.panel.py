"""Host seconds a job spends forecasting its locations: the span around
the forecast_with_nowcasts calls."""

from ._shared import span_mean


def read(ctx):
    return span_mean(ctx, "forecast")
