"""Percent: the fit's counted LML calls' least time over the device's busy
time in the fit."""

from ._shared import roofline


def read(ctx):
    return roofline(ctx, "fit")
