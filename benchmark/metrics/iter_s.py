"""iter_s: the window's seconds over the BO iterations it completed (whole
episodes only)."""


def read(run):
    if run["kind"] != "loop":
        return None
    return run["window_s"] / run["iterations"]
