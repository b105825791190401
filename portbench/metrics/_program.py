"""The program's own run record of the measured window
(``functionalmf_tpu_torch/utils/telemetry.py``): the latest record of the
process whose sweep count is the window's (stretch 1: no span, no
profiler). None where the program keeps no record (a checkout without the
module, or a model with ``trace_runs`` off) or where none matches."""


def window_record(t):
    try:
        from functionalmf_tpu_torch.utils import telemetry
    except ImportError:
        return None
    for rec in reversed(telemetry.recent()):
        if rec.get("sweeps") == t.nsweeps and t.nsweeps:
            return rec
    return None


def host_ms(t, key):
    """ms a call of the window's host-clock span ``key``."""
    rec = window_record(t)
    return None if rec is None else rec["host_ms"].get(key)


def stream_ms_per_sweep(t, key):
    """ms a sweep of the window's stream-clock span ``key``; None where
    the span never ran."""
    rec = window_record(t)
    if rec is None or key not in rec["stream_ms"]:
        return None
    return rec["stream_ms"][key] / rec["sweeps"]
