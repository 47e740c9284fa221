"""``torch.cuda.max_memory_reserved`` over the window, in GiB: what the process
holds on the card (a CUDA graph's pool included), which bounds the batch."""


def read(obs):
    peak = obs["peak_mem_bytes_window"]
    return peak / 2 ** 30 if peak else None
