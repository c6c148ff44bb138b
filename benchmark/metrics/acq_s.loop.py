"""acq_s.loop: the ledger's "Acquisition Optimization" seconds per
iteration."""
from benchmark.metrics._ledger import per_iteration


def read(run):
    return per_iteration(run, "Acquisition Optimization")
