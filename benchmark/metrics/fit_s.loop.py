"""fit_s.loop: the ledger's "GP Training" seconds per iteration (the GP
update and the refits of the loop's schedule)."""
from benchmark.metrics._ledger import per_iteration


def read(run):
    return per_iteration(run, "GP Training")
