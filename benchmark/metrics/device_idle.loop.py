"""device_idle.loop: the share of the profiled episode's wall time in which
no device operation ran (the union of their intervals, not their sum)."""
from benchmark.metrics._device import idle_percent


def read(run):
    return idle_percent(run, "loop")
