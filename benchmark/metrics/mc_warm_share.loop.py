"""mc_warm_share.loop: the share of the window's MC-pool refreshes that
kept their warm start (the rest re-ran the ensemble's full cold warmup,
work the loop waits for at its join)."""


def read(run):
    if run["kind"] != "loop" or not run["warm"]:
        return None
    return 100.0 * sum(run["warm"]) / len(run["warm"])
