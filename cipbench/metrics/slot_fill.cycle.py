"""Percent of B1's slot visits that add to a plane: the program's counters ``useful_visits`` over ``slot_visits``."""
from cipbench.recorded import counter


def read(run):
    useful, visits = counter("useful_visits"), counter("slot_visits")
    if run.unit != "cycle" or not useful or not visits:
        return None
    return 100.0 * useful / visits
