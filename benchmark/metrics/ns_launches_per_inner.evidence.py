"""ns_launches_per_inner.evidence: device operations (kernels, copies,
sets) in the profiled slice over its NS inner iterations."""


def read(run):
    s = run.get("slice")
    if run["kind"] != "evidence" or not s or not s.get("launches") \
            or not s.get("n_inner"):
        return None
    return s["launches"] / s["n_inner"]
