"""Both attention kernels (``attn_*``, small and flash): the sum of their
bounds over every layer of the traced calls, over their device time."""

from portbench.profile import device_seconds
from portbench.roofline import attention_calls_s


def read(obs):
    spent = device_seconds(obs["trace"], "attn_")
    if not spent:
        return None
    return 100.0 * attention_calls_s(obs["config"], obs["traced_calls"], obs["frames"]) / spent
