"""Per-iteration seconds of a phase of the program's timing ledger
(utils/results.py), over the traced window of a loop cell."""


def per_iteration(run, phase):
    if run["kind"] != "loop" or phase not in run["ledger"]:
        return None
    return run["ledger"][phase] / run["iterations"]


def untracked(run):
    """The window's seconds outside every phase that runs on the loop's own
    thread (the overlapped refresh runs beside the likelihood batch), less
    the harness's restores and records, per iteration."""
    if run["kind"] != "loop":
        return None
    tracked = sum(t for p, t in run["ledger"].items()
                  if not p.endswith("(overlapped)"))
    return (run["window_s"] - tracked - run["harness_s"]) / run["iterations"]
