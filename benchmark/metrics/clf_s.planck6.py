"""clf_s.planck6: the ledger's "Classifier Training" seconds per
iteration."""
from benchmark.metrics._ledger import per_iteration


def read(run):
    return per_iteration(run, "Classifier Training")
