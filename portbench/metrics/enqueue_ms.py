"""Host milliseconds a batch in ``Segmenter.process_async`` (padding, upload,
enqueue), the mean over the window's batches."""


def read(obs):
    spans = obs["spans"]["enqueue"]
    return 1e3 * sum(spans) / len(spans) if spans else None
