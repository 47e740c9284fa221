"""Host milliseconds a batch in ``finalize`` (the wait for the device and the
copies to the host), the mean over the window's batches."""


def read(obs):
    spans = obs["spans"]["finalize"]
    return 1e3 * sum(spans) / len(spans) if spans else None
