"""device_idle.evidence: the share of the profiled NS slice's wall time in
which no device operation ran (the union of their intervals)."""
from benchmark.metrics._device import idle_percent


def read(run):
    return idle_percent(run, "evidence")
