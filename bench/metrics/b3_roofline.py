"""B3's share of its roofline (%): the least time of the frames it served
in the traced window over its device time there (``bench/bounds/b3.py``)."""

from benchlib.roofline import share_pct


def read(run):
    return share_pct(run, "b3")
