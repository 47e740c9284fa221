"""Neural vocoder of the port: articulatory features -> 16 kHz waveform.

Port of the inference half of ``sylber_tpu/vocoder``: the HiFi-GAN
generator with its optional NSF harmonic source (:mod:`.hifigan`), the
log-mel spectrogram (:mod:`.mel`) and the articulatory decoder wrapper
(:mod:`.sparc`). The discriminators and the vocoder's train step are not
ported yet.
"""

from .hifigan import Generator, HiFiGANConfig
from .sparc import SparcDecoder, SparcDecoderConfig

__all__ = ["Generator", "HiFiGANConfig", "SparcDecoder", "SparcDecoderConfig"]
