"""K1's share [%] of its bound over the window: the work the CCD's
inputs need (portbench/work.py, frozen) over the kernel's device time
by name in the trace."""
from portbench import work


def read(rec):
    return work.roofline(rec, "k1")
