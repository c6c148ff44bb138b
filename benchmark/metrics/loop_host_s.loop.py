"""loop_host_s.loop: the BO loop's own host seconds per iteration, outside
its ledger's phases (the ledger's "untracked"), the harness's restores and
records left out."""
from benchmark.metrics._ledger import untracked as read  # noqa: F401
