"""gram_bwd_roofline.gauss30: the Gram backward in the lengthscales and
amplitude, its share of its roofline over the profiled episode."""
from benchmark.metrics._device import roofline, roofline_percent


def read(run):
    return roofline_percent(run, "backward")


def detail(run):
    """What binds the launches' bound, the bound and the device seconds."""
    return roofline(run, "backward")
