"""ms a sweep in the scale moves (``models/constrained.py:
_interweave_scales``, the slice loops of ``samplers/slice1d.py``), a
synchronised span wrapped from outside."""
UNIT = "ms"


def read(t):
    return t.spans.get("scale_moves")
