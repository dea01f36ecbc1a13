"""Percent of the traced requests' window in which no operation ran on the
device."""

from benchmark.readers import idle


def read(ctx):
    return idle(ctx)
