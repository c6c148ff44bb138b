"""ns_inner_ms.evidence: milliseconds per NS inner iteration: the window's
nested-sampling seconds over the inner iterations the results return."""


def read(run):
    if run["kind"] != "evidence":
        return None
    n = sum(r["n_inner"] for r in run["evidences"])
    if n <= 0:
        return None
    return 1e3 * sum(r["seconds"] for r in run["evidences"]) / n
