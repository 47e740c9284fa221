"""HTTP front end over the port's inference stack (standard library only).

Port of ``scripts/serve_http.py``:

POST /segment       body: raw little-endian int16 or float32 PCM at 16 kHz
                    (X-Dtype: int16|float32, default int16); optional query
                    parameters norm_threshold, merge_threshold (floats; the
                    server groups requests with the same thresholds into one
                    batch), in_second=0|1 (default 1: boundaries in seconds)
                    -> JSON {segments: [[s, e], ...], segment_features:
                    [[...]], num_segments: K}
POST /tokenize      same body; needs --centroids. Segments through the
                    micro-batcher, then nearest-centroid token ids
                    -> JSON {tokens, segments, durations, num_segments}
POST /resynthesize  same body; needs --synthesis-ckpt. The resynthesis chain
                    (``SegmentSynthesis``) on the utterance, one sampler at a
                    time, outside the micro-batcher; steps= (default 5)
                    -> JSON {art: [[14 floats] x L], segments}; with audio=1
                    (needs --vocoder-ckpt) -> audio/wav, 16 kHz int16
GET  /stats         -> JSON serving counters
GET  /healthz       -> 200

Errors: 400 for a bad request (too short, bad parameter), 413 for a body
over --max-body-bytes (refused before it is read), 503 for a stack that is
not configured (/tokenize without --centroids, /resynthesize without
--synthesis-ckpt, audio=1 without --vocoder-ckpt), 500 otherwise; the server keeps serving. Throughput comes
from many concurrent connections coalescing in the micro-batcher
(``ThreadingHTTPServer`` gives each connection a thread; the device is
driven by the one dispatcher thread of ``sylber_tpu_torch.serve``).

Usage:
  python -m sylber_tpu_torch.serve_http --device cuda --ckpt sylber.ckpt \\
      --port 8787 [--max-batch 32] [--max-wait-ms 10] [--bf16 | --int8] \\
      [--centroids km.npy [--residual-centroids km2.npy]] \\
      [--synthesis-ckpt synth.npz|synthesis.ckpt [--synthesis-config cfg.yaml]] \\
      [--vocoder-ckpt vocoder.npz|generator.ckpt [--vocoder-config cfg.json]]
"""

from __future__ import annotations

import argparse
import io
import json
import threading
import wave
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import parse_qs, urlparse

import numpy as np


class _TooLarge(Exception):
    """Request body exceeds the configured limit (HTTP 413)."""


def wav_bytes(pcm: np.ndarray, sr: int = 16000) -> bytes:
    """float32 in (-1, 1) -> RIFF/WAV int16 bytes."""
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(np.clip(pcm * 32767.0, -32768, 32767).astype("<i2").tobytes())
    return buf.getvalue()


def build_handler(server, quantizer=None, max_body_bytes: int = 8 << 20, synth=None,
                  vocoder=None, spk_emb=None, pitch_mean: float = 120.0):
    """Handler class over a ``SegmenterServer``, an optional k-means
    quantizer (``sylber_tpu_torch.quantizer``) for /tokenize, and an
    optional ``SegmentSynthesis`` (with a ``SparcDecoder`` for audio out)
    for /resynthesize.

    ``max_body_bytes`` (default 8 MiB, about 4.4 min of int16 PCM) refuses
    larger POSTs with 413 before reading the body: one request could
    otherwise allocate any host buffer and push any length into the
    batcher. Long recordings belong to ``LongFormSegmenter``."""
    from .tokenizer import durations, encode

    synth_lock = threading.Lock()  # one sampler at a time on the device

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self._responded = True
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            self._responded = False
            try:
                if self.path == "/healthz":
                    self._json(200, {"ok": True})
                elif self.path == "/stats":
                    s = server.stats()
                    self._json(200, {k: getattr(s, k) for k in s.__dataclass_fields__}
                               | {"mean_batch_size": s.mean_batch_size})
                else:
                    self._json(404, {"error": "not found"})
            except (BrokenPipeError, ConnectionError):
                pass
            except Exception as e:  # same per-request isolation as do_POST
                if self._responded:
                    self.close_connection = True
                    return
                self._json(500, {"error": str(e)})

        def _read_wav(self) -> np.ndarray:
            n = int(self.headers.get("Content-Length", 0))
            if n > max_body_bytes:
                raise _TooLarge(f"body {n} bytes > limit {max_body_bytes}; use "
                                "LongFormSegmenter for long recordings")
            raw = self.rfile.read(n)
            if self.headers.get("X-Dtype", "int16") == "float32":
                return np.frombuffer(raw, "<f4").astype(np.float32)
            return np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0

        def _refuse(self, code: int, error: str) -> None:
            """Answer without using the body, after reading it when it is
            within the limit: a socket closed with unread bytes resets, and
            the client may lose the answer."""
            n = int(self.headers.get("Content-Length", 0))
            if n <= max_body_bytes:
                self.rfile.read(n)
            else:
                self.close_connection = True
            self._json(code, {"error": error})

        def do_POST(self):
            url = urlparse(self.path)
            q = parse_qs(url.query)
            self._responded = False
            try:
                if url.path == "/segment":
                    self._segment(q)
                elif url.path == "/tokenize":
                    self._tokenize(q)
                elif url.path == "/resynthesize":
                    self._resynthesize(q)
                else:
                    self._refuse(404, "not found")
            except (BrokenPipeError, ConnectionError):
                pass  # client went away; nothing sane to send
            except Exception as e:  # per-request isolation
                if self._responded:
                    # the response is already on the wire: a second status
                    # line would corrupt the stream, so drop the connection
                    self.close_connection = True
                    return
                if isinstance(e, _TooLarge):
                    code = 413
                elif isinstance(e, (ValueError, KeyError)):
                    code = 400
                else:
                    code = 500
                self._json(code, {"error": str(e)})
                if isinstance(e, _TooLarge):
                    # the unread body is still on the socket; do not parse
                    # it as the next request
                    self.close_connection = True

        def _segment_kw(self, q):
            kw = {}
            for name in ("norm_threshold", "merge_threshold"):
                if name in q:
                    kw[name] = float(q[name][0])
            if "in_second" in q:
                kw["in_second"] = q["in_second"][0] not in ("0", "false")
            return kw

        def _segment(self, q):
            out = server.segment(self._read_wav(), **self._segment_kw(q))
            self._json(200, {
                "segments": np.asarray(out["segments"]).tolist(),
                "segment_features": np.asarray(out["segment_features"]).tolist(),
                "num_segments": int(len(out["segments"])),
            })

        def _tokenize(self, q):
            if quantizer is None:
                self._refuse(503, "no --centroids configured")
                return
            kw = self._segment_kw(q)
            out = server.segment(self._read_wav(), **kw)
            feats = np.asarray(out["segment_features"])
            tokens = encode(quantizer, feats)
            segs = np.asarray(out["segments"])
            self._json(200, {
                "tokens": tokens.reshape(len(feats), -1).tolist()
                if tokens.ndim > 1 else tokens.tolist(),
                "segments": segs.tolist(),
                "durations": durations(segs, kw.get("in_second", True)).tolist(),
                "num_segments": int(len(segs)),
            })

        def _resynthesize(self, q):
            if synth is None:
                self._refuse(503, "no --synthesis-ckpt configured")
                return
            steps = int(q.get("steps", ["5"])[0])
            want_audio = q.get("audio", ["0"])[0] not in ("0", "false")
            if want_audio and vocoder is None:
                self._refuse(503, "no --vocoder-ckpt configured")
                return
            wav = self._read_wav()
            with synth_lock:
                art, segs = synth.resynthesize(input_values=wav[None], steps=steps)
                if want_audio:
                    spk = (np.zeros(vocoder.config.spk_emb_dim, np.float32)
                           if spk_emb is None else spk_emb)
                    out = synth.decode_audio(art, spk, pitch_mean=pitch_mean,
                                             vocoder=vocoder)[0]
            if want_audio:
                body = wav_bytes(out)
                self._responded = True
                self.send_response(200)
                self.send_header("Content-Type", "audio/wav")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._json(200, {"art": art[0].tolist(),
                                 "segments": segs[0].tolist() if segs is not None else None})

    return Handler


def _read_config(path: str) -> dict:
    """A YAML (or JSON) config: the model block itself, or a recipe or a
    fixture's metadata holding it under ``model`` / ``config.model``."""
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    cfg = cfg.get("config", cfg)
    return cfg.get("model", cfg)


def build_synthesis_stack(synthesis_ckpt: str, synthesis_config: str, device,
                          quantizer=None, vocoder_ckpt=None, vocoder_config=None):
    """``(SegmentSynthesis, SparcDecoder or None)`` from checkpoint paths: a
    JAX-layout ``.npz``, an Orbax directory of the JAX package or a reference
    torch checkpoint for each. ``vocoder_config`` holds ``{"generator": {...}}``
    (HiFiGANConfig fields; default ``SparcDecoderConfig()``)."""
    from .synthesis import SegmentSynthesis, synthesis_config_from_dict
    from .vocoder.hifigan import HiFiGANConfig
    from .vocoder.sparc import SparcDecoderConfig, load_decoder

    model = _read_config(synthesis_config)
    synth = SegmentSynthesis(model_ckpt=synthesis_ckpt, config=synthesis_config_from_dict(model),
                             thresholder_configs=model.get("thresholder_configs"),
                             quantizer=quantizer, device=device)
    vocoder = None
    if vocoder_ckpt:
        dcfg = SparcDecoderConfig()
        if vocoder_config:
            with open(vocoder_config) as f:
                dcfg = SparcDecoderConfig(generator=HiFiGANConfig(**json.load(f)["generator"]))
        vocoder = load_decoder(vocoder_ckpt, dcfg, device=device)
    return synth, vocoder


def segmenter_config(encoding_layer: int, bf16: bool = False, int8: bool = False):
    """The served encoder's ``HubertConfig``: fp32 parity mode, the bf16 fast
    mode, or (``int8``) the bf16 fast mode with dynamic W8A8 encoder
    products (``scripts/serve_http.py``'s ``--int8``)."""
    from .models.hubert import HubertConfig

    if bf16 or int8:
        return HubertConfig(num_hidden_layers=encoding_layer, dtype="bfloat16",
                            frontend_dtype="bfloat16", precision="default", int8_encoder=int8)
    return HubertConfig(num_hidden_layers=encoding_layer)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", default=None,
                   help="torch sylber.ckpt state dict or JAX .npz parameters "
                        "(default: seeded random weights)")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    p.add_argument("--port", type=int, default=8787)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--max-batch", type=int, default=32)
    p.add_argument("--max-wait-ms", type=float, default=10.0)
    p.add_argument("--bf16", action="store_true",
                   help="bf16 fast mode (default: fp32 parity mode)")
    p.add_argument("--int8", action="store_true",
                   help="dynamic W8A8 int8 encoder products on the int8 kernels (implies "
                        "the bf16 fast mode elsewhere)")
    p.add_argument("--encoding-layer", type=int, default=9,
                   help="encoder depth (reference Segmenter argument)")
    p.add_argument("--no-warmup", action="store_true")
    p.add_argument("--centroids", default=None,
                   help="k-means centroid .npy -> enables POST /tokenize")
    p.add_argument("--residual-centroids", default=None)
    p.add_argument("--synthesis-ckpt", default=None,
                   help="SegmentSynthesis weights, a JAX-layout .npz (hubert, input_mlp, "
                        "regressor) or a reference torch checkpoint -> enables "
                        "POST /resynthesize")
    p.add_argument("--synthesis-config",
                   default=str(Path(__file__).resolve().parent.parent / "configs"
                               / "sylber_resynthesis.yaml"),
                   help="resynthesis YAML (or a fixture's JSON metadata)")
    p.add_argument("--vocoder-ckpt", default=None,
                   help="HiFi-GAN generator, a JAX-layout .npz or a torch checkpoint -> "
                        "enables /resynthesize?audio=1")
    p.add_argument("--vocoder-config", default=None,
                   help='JSON with {"generator": {HiFiGANConfig fields}} '
                        "(default: SparcDecoderConfig())")
    p.add_argument("--spk-emb", default=None, help=".npy speaker embedding")
    p.add_argument("--pitch-mean", type=float, default=120.0)
    p.add_argument("--max-body-bytes", type=int, default=8 << 20,
                   help="refuse larger POST bodies with 413 (default 8 MiB, "
                        "about 4.4 min of int16 PCM)")
    args = p.parse_args(argv)

    from .api import Segmenter
    from .quantizer import load_km_quantizer
    from .serve import SegmenterServer

    cfg = segmenter_config(args.encoding_layer, args.bf16, args.int8)
    seg = Segmenter(model_ckpt=args.ckpt, hubert_config=cfg,
                    encoding_layer=args.encoding_layer, device=args.device)
    server = SegmenterServer(seg, max_batch=args.max_batch, max_wait_ms=args.max_wait_ms)
    quantizer = (load_km_quantizer(args.centroids, args.residual_centroids,
                                   device=seg.device) if args.centroids else None)
    synth = vocoder = None
    if args.synthesis_ckpt:
        synth, vocoder = build_synthesis_stack(args.synthesis_ckpt, args.synthesis_config,
                                               seg.device, quantizer, args.vocoder_ckpt,
                                               args.vocoder_config)
    spk = np.load(args.spk_emb).astype(np.float32) if args.spk_emb else None
    if not args.no_warmup:
        print("warming the batch buckets ...", flush=True)
        server.warmup()
    httpd = ThreadingHTTPServer((args.host, args.port),
                                build_handler(server, quantizer, args.max_body_bytes, synth,
                                              vocoder, spk, args.pitch_mean))
    print(f"serving on http://{args.host}:{httpd.server_address[1]}", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        server.stop()


if __name__ == "__main__":
    main()
