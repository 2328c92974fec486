"""Percent: the request's counted LML calls' least time over the device's
busy time in the request."""

from ._shared import roofline


def read(ctx):
    return roofline(ctx, "request")
