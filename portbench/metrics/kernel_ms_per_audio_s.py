"""Device milliseconds of kernels an audio second: the summed device time of
the traced stretch's operations but its copies and memsets, over the audio
seconds of the calls it ran (unpadded). Where the host sets the window's pace, as in the corpus
cell, this shows the device's own work with the host's noise left out: the
copies are out because the host's side of a pageable copy paces it."""

from portbench.traffic.synthetic import SR


def read(obs):
    trace = obs["trace"]
    if trace is None:
        return None
    kernels = sum(s for name, s in trace.by_name.items()
                  if not name.startswith(("Memcpy", "Memset")))
    audio_s = sum(sum(lens) for _, _, lens in obs["traced_calls"]) / SR
    if not kernels or not audio_s:
        return None
    return 1e3 * kernels / audio_s
