"""Percent of the H100's 67 TFLOP/s: the panel fit's counted operations
over its wall-clock."""

from ._shared import mfu


def read(ctx):
    return mfu(ctx, "fit")
