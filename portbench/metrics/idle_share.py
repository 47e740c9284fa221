"""The share of the traced stretch with no kernel, copy or memset on the
card (the union of the device's intervals)."""


def read(obs):
    trace = obs["trace"]
    if trace is None or not trace.window_s or not trace.busy_s:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
