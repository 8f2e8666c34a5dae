"""Kernel A (kernels.sc_decode, csrc/sc_decode.cu) against its roofline:
the least time of one launch at the cell's [batch, 65536] (the frozen
count of reference/roofline.py) over sc_decode_kernel's mean device ms
a launch in the traced slice, in %."""

from harness.layers import roofline_pct


def read(run):
    return roofline_pct(run, "sc_decode_kernel", run.cell["params"]["batch"],
                        1)
