"""Columns the OSD's host-driven GF(2) elimination walks in a
Decoder.decode call: the program's ``osd_steps`` counter over
``decoder.decode`` (255 an OSD call), over the traced calls."""

from harness.spans import call_counter


def read(run):
    return call_counter("osd_steps")
