"""Readings of the profiled slice's device trace."""
from benchmark.counts.bounds import bound_ms


def idle_percent(run, kind):
    s = run.get("slice")
    if run["kind"] != kind or not s or not s.get("busy_s"):
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["wall_s"])


def roofline(run, kernel):
    """The launches of one Gram kernel in the profiled slice: their summed
    bound (bounds.bound_ms at each launch's own shape), their summed device
    time, and what binds the most of the bound (bytes or operations). None
    where the slice has no launch of it; an error where the trace's
    launches and the recorded shapes do not pair one to one, since a share
    of the wrong launches would be read as the kernel's."""
    s = run.get("slice")
    if not s or "gram" not in s:
        return None
    times = [t for k, t in s["gram"] if k == kernel]
    shapes = [sh for sh in s["shapes"] if sh[0] == kernel]
    if not times and not shapes:
        return None
    if len(times) != len(shapes):
        raise RuntimeError(
            f"{len(times)} {kernel} launches in the device trace against "
            f"{len(shapes)} recorded shapes")
    by = {"bytes": 0.0, "operations": 0.0}
    for k, cap, d, lanes, pl in shapes:
        ms, what = bound_ms(k, cap, d, lanes, per_lane=pl)
        by[what] += ms * 1e-3
    return {"bound_s": sum(by.values()), "device_s": sum(times),
            "launches": len(times), "bound_by": max(by, key=by.get)}


def roofline_percent(run, kernel):
    """The launches' summed bound over their summed device time, in %."""
    r = roofline(run, kernel)
    return None if r is None else 100.0 * r["bound_s"] / r["device_s"]
