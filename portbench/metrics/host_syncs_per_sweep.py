"""Host waits on the device a sweep in the profiled window: the calls to
cudaStreamSynchronize, cudaDeviceSynchronize, cudaEventSynchronize and
the synchronous cudaMemcpy (``models/base.py:run_gibbs`` and the sync
sites under it: a scalar read or a copy to the host waits in these)."""
UNIT = "syncs"


def read(t):
    if t.prof is None:
        return None
    return t.prof["syncs"] / t.prof["sweeps"]
