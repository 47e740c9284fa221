"""Both segmentation passes (``segment_pass*``): their bytes bound over the
traced calls' shapes (the batches of a segmenter cell, the teacher's
forwards of a training cell), over their device time."""

from portbench.profile import device_seconds
from portbench.roofline import segmentation_calls_s


def read(obs):
    spent = device_seconds(obs["trace"], "segment_pass")
    if not spent:
        return None
    return 100.0 * segmentation_calls_s(obs["config"], obs["traced_calls"], obs["frames"]) / spent
