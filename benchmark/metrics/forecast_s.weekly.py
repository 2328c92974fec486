"""Host seconds a job spends forecasting: the span around
forecast_with_nowcasts or forecast."""

from ._shared import span_mean


def read(ctx):
    return span_mean(ctx, "forecast")
