"""Unpadded audio seconds whose results reached the host in the window, over
the window's wall: the corpus cell's rate as its user waits for it, paced by
the host's padding and pageable copies, which a shared host makes vary from
process to process."""


def read(obs):
    if not obs["window_s"] or not obs.get("audio_s"):
        return None
    return obs["audio_s"] / obs["window_s"]
