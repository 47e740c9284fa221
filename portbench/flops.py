"""Operation counts of the HuBERT encoder, and the H100's peaks.

Copied from ``sylber_tpu_torch/utils/profiling.py`` (``hubert_train_flops``,
``H100_PEAK_FLOPS``), with the forward of one utterance counted apart so
that inference counts each utterance at its own length. Multiply-adds count
2; the frontend convs, the projection, the positional conv, the q/k/v/out
projections, the attention's two products and the feed-forward are
counted; norms, activations and softmax are not.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable

# NVIDIA's H100 SXM data sheet, dense, at the 700 W power limit
H100_PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
H100_BYTES_PER_S = 3.35e12


def frames(cfg: Dict[str, Any], num_samples: int) -> int:
    """Frames of ``num_samples`` samples: floor((L - k) / s) + 1 a conv."""
    length = num_samples
    for k, s in zip(cfg["conv_kernel"], cfg["conv_stride"]):
        length = (length - k) // s + 1
    return length


def forward_flops(cfg: Dict[str, Any], num_samples: int) -> float:
    """Operations of one forward of one utterance of ``num_samples`` samples,
    its attention over its own frames."""
    t = frames(cfg, num_samples)
    conv, length, in_ch = 0.0, num_samples, 1
    for ch, k, s in zip(cfg["conv_dim"], cfg["conv_kernel"], cfg["conv_stride"]):
        length = (length - k) // s + 1
        conv += 2.0 * length * ch * in_ch * k
        in_ch = ch
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    per_layer = (2.0 * t * d * d * 4          # q, k, v and out projections
                 + 2.0 * t * t * d * 2        # scores and weighted sum
                 + 2.0 * t * d * f * 2)       # feed-forward
    proj = 2.0 * t * cfg["conv_dim"][-1] * d
    pos = 2.0 * t * d * (d // cfg["num_conv_pos_embedding_groups"]) * cfg["num_conv_pos_embeddings"]
    return conv + proj + pos + per_layer * cfg["num_hidden_layers"]


def inference_flops(cfg: Dict[str, Any], lengths: Iterable[int]) -> float:
    """One forward of each utterance at its unpadded length."""
    return sum(forward_flops(cfg, int(n)) for n in lengths)


def train_step_flops(cfg: Dict[str, Any], batch_size: int, num_samples: int) -> float:
    """A distillation step on ``batch_size`` crops: the teacher's forward
    and the student's forward and backward, counted as four forwards."""
    return batch_size * forward_flops(cfg, num_samples) * 4.0


def peak_flops(dtype: str, precision: str = "highest") -> float:
    """bf16 on the tensor cores; fp32 as TF32 under ``"default"``, else on
    the CUDA cores."""
    if dtype == "bfloat16":
        return H100_PEAK_FLOPS["bfloat16"]
    return H100_PEAK_FLOPS["tf32" if precision != "highest" else "float32"]
