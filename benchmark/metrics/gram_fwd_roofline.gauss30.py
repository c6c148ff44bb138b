"""gram_fwd_roofline.gauss30: the Gram forward kernel's share of its
roofline over the profiled episode: its launches' bound over their device
time."""
from benchmark.metrics._device import roofline, roofline_percent


def read(run):
    return roofline_percent(run, "forward")


def detail(run):
    """What binds the launches' bound, the bound and the device seconds."""
    return roofline(run, "forward")
