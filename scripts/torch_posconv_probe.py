#!/usr/bin/env python3
"""Time the HuBERT positional conv of the PyTorch port on one GPU, two ways.

    python3 scripts/torch_posconv_probe.py

The positional conv is a grouped Conv1d (768 channels, kernel 128, 16
groups). In bf16 it runs either as cuDNN's bf16 grouped conv or as an fp32
conv on the bf16-rounded input, weight and bias (TF32 under ``"default"``
precision, where bf16 values are exact), cast to bf16;
``sylber_tpu_torch/models/hubert.py::PositionalConvEmbedding`` picks the
fp32 form when autograd records and, without it, from
``POS_CONV_FP32_FRAMES`` frames (batch x length) on. The script prints:

1. the forward without autograd of both forms over a grid of batch sizes
   and lengths (the Segmenter's batch buckets, the trainer's B100, lengths
   from a streaming hop to a long-form window), with the form the port
   picks and its time;
2. at the trainer's B100 x L250, the Segmenter's B32 x L250 and L1000 and a
   long-form window batch B8 x L1549, the forward + backward of both forms
   and their largest difference;
3. the full-width student's forward and backward (9 layers, B100 x 80,320
   samples, train mode) with each form.

Times are CUDA events, the mean of 3 calls after a warm-up. Needs a CUDA
device; prints the card's name and power limit.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    import torch
    import torch.nn.functional as F

    from sylber_tpu_torch.models import hubert

    if not torch.cuda.is_available():
        print("torch_posconv_probe: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")

    def ms(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def cudnn_bf16(self, x):
        """The positional conv as cuDNN's bf16 grouped conv."""
        dt = self.cfg.dtype
        out = F.conv1d(x.transpose(1, 2).to(dt), self.conv.weight.to(dt),
                       self.conv.bias.to(dt), padding=self.conv.padding,
                       groups=self.conv.groups)[:, :, :-1]
        return hubert._gelu(out, self.cfg.gelu_approximate).transpose(1, 2)

    def fp32_rounded(self, x):
        """The positional conv as an fp32 conv on bf16-rounded tensors."""
        dt = self.cfg.dtype
        rounded = lambda t: t.to(dt).float()  # noqa: E731
        out = F.conv1d(rounded(x.transpose(1, 2)), rounded(self.conv.weight),
                       rounded(self.conv.bias), padding=self.conv.padding,
                       groups=self.conv.groups).to(dt)[:, :, :-1]
        return hubert._gelu(out, self.cfg.gelu_approximate).transpose(1, 2)

    port = hubert.PositionalConvEmbedding.forward
    forms = (("fp32_rounded", fp32_rounded), ("cudnn_bf16", cudnn_bf16))
    cfg = hubert.HubertConfig(dtype="bfloat16", frontend_dtype="bfloat16", precision="default")
    pos = hubert.PositionalConvEmbedding(cfg).to(dev)
    torch.nn.init.normal_(pos.conv.weight, 0.0, 0.01)
    print(f"card: {smi}; torch {torch.__version__}; POS_CONV_FP32_FRAMES "
          f"{hubert.POS_CONV_FP32_FRAMES}", flush=True)
    with hubert.matmul_precision("default"), torch.no_grad():
        for B in (1, 2, 4, 8, 16, 32, 64, 100):
            for L in (199, 250, 500, 750, 1000, 1549):
                x = torch.randn(B, L, 768, device=dev, dtype=torch.bfloat16)
                t = {name: ms(lambda: fwd(pos, x)) for name, fwd in forms}
                pick = ("fp32_rounded" if B * L >= hubert.POS_CONV_FP32_FRAMES
                        else "cudnn_bf16")
                t_port = ms(lambda: port(pos, x))
                print(f"no-grad forward B{B} L{L} ({B * L} frames): fp32_rounded "
                      f"{t['fp32_rounded']:.3f} ms, cudnn_bf16 {t['cudnn_bf16']:.3f} ms, "
                      f"port picks {pick} {t_port:.3f} ms", flush=True)
                del x
    with hubert.matmul_precision("default"):
        for B, L in ((100, 250), (32, 250), (32, 1000), (8, 1549)):
            x = torch.randn(B, L, 768, device=dev, dtype=torch.bfloat16, requires_grad=True)
            res = {}
            for name, fwd in forms:
                with torch.no_grad():
                    res[name] = fwd(pos, x).float()
                    res[f"{name}_fwd_ms"] = ms(lambda: fwd(pos, x))
                res[f"{name}_fwd_bwd_ms"] = ms(lambda: fwd(pos, x).float().sum().backward())
            diff = (res.pop("fp32_rounded") - res.pop("cudnn_bf16")).abs().max().item()
            print(f"B{B} L{L} bf16: " + ", ".join(f"{k} {v:.3f}" for k, v in res.items())
                  + f", max |fp32_rounded - cudnn_bf16| {diff:.3g}  [{smi}]", flush=True)
            del x
        model = hubert.init_weights(hubert.HubertModel(cfg), torch.Generator().manual_seed(0))
        model = model.to(dev).train()
        wav = torch.randn(100, 80320, device=dev)
        mask = torch.ones(100, 80320, dtype=torch.int32, device=dev)
        for name, fwd in forms:
            hubert.PositionalConvEmbedding.forward = fwd
            try:
                t = ms(lambda: model(wav, mask).float().square().mean().backward(), reps=2)
            finally:
                hubert.PositionalConvEmbedding.forward = port
            print(f"student forward + backward, 9 layers, B100 x 80320, bf16, positional "
                  f"conv {name}: {t:.1f} ms  [{smi}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
