"""Percent of B1's owner-cell adds whose sum carries over in registers from the slot before: the program's counters ``register_hits`` over ``register_adds`` (``ops/gridder.py:register_reuse``, counted on the plan)."""
from cipbench.recorded import counter


def read(run):
    hits, adds = counter("register_hits"), counter("register_adds")
    if run.unit != "cycle" or hits is None or not adds:
        return None
    return 100.0 * hits / adds
