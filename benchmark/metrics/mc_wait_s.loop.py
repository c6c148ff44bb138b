"""mc_wait_s.loop: the ledger's "MCMC Join Wait" seconds per iteration (the
overlapped MC-pool refresh, waited for after the likelihood batch)."""
from benchmark.metrics._ledger import per_iteration


def read(run):
    return per_iteration(run, "MCMC Join Wait")
