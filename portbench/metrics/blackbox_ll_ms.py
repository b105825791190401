"""ms a sweep in the W and V updates' lifted black-box likelihood calls
(``models/constrained.py:_w_loglik_blackbox``, ``_v_loglik_blackbox``:
the user's function lifted by ``torch.func.vmap``), a synchronised span
around each call. The scale moves' full-tensor calls are inside
``scale_moves_ms``. None on a path with a cell function."""
UNIT = "ms"


def read(t):
    return t.spans.get("blackbox_ll")
