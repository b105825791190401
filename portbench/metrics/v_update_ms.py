"""ms a sweep in the V update's rounds (``models/constrained.py:
_update_V_gass``), a synchronised span wrapped from outside."""
UNIT = "ms"


def read(t):
    return t.spans.get("v_update")
