"""Kernel B (kernels.scl_decode, csrc/scl_decode.cu, exact) against its
roofline at the escalation's [fallback_batch, 65536], list 8: the least
time of one launch (the frozen count of reference/roofline.py) over
scl_decode_kernel's mean device ms a launch in the traced slice, in %;
nothing where the slice escalated no frame."""

from harness.layers import roofline_pct


def read(run):
    dec = run.cell["config"]["decoder"]
    return roofline_pct(run, "scl_decode_kernel", dec["fallback_batch"],
                        dec["list_size"])
