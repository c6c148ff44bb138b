"""evidence_s: the window's seconds over the convergence evidences it
completed (the one in flight at the window's end is completed and
counted)."""


def read(run):
    if run["kind"] != "evidence":
        return None
    return run["window_s"] / run["units"]
