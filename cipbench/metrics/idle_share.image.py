"""Percent of the traced window in which nothing ran on the device."""
from cipbench.readers import idle_share


def read(run):
    return idle_share(run, "image")
