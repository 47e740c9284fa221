"""Neural vocoder of the port: articulatory features -> 16 kHz waveform.

Port of ``sylber_tpu/vocoder``: the HiFi-GAN generator with its optional
NSF harmonic source, its discriminators and adversarial train step
(:mod:`.hifigan`), the log-mel spectrogram (:mod:`.mel`) and the
articulatory decoder wrapper (:mod:`.sparc`).
"""

from .hifigan import Generator, HiFiGANConfig, VocoderTrainConfig, make_vocoder_train_step
from .sparc import SparcDecoder, SparcDecoderConfig

__all__ = ["Generator", "HiFiGANConfig", "SparcDecoder", "SparcDecoderConfig",
           "VocoderTrainConfig", "make_vocoder_train_step"]
