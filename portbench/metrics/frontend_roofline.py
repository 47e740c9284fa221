"""Frontend layer 0's kernels (``conv0_*``): the sum of their bounds over the
traced calls' shapes (the batches of a segmenter cell, the teacher's
forwards of a training cell), over the sum of their device times."""

from portbench.profile import device_seconds
from portbench.roofline import frontend_calls_s


def read(obs):
    spent = device_seconds(obs["trace"], "conv0_")
    if not spent:
        return None
    return 100.0 * frontend_calls_s(obs["config"], obs["traced_calls"]) / spent
