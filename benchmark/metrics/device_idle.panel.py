"""Percent of a unit's wall-clock in which no operation ran on the device."""

from ._shared import idle


def read(ctx):
    return idle(ctx)
