"""Kernel B (kernels.scl_decode, csrc/scl_decode.cu, exact) at the
Decoder's [1, 65536], list 8, against its roofline: the least time of
one launch (the frozen count of reference/roofline.py) over
scl_decode_kernel's mean device ms a launch in the traced calls, in %."""

from harness.layers import roofline_pct


def read(run):
    return roofline_pct(run, "scl_decode_kernel", 1,
                        run.cell["config"]["decoder"]["list_size"])
