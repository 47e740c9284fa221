#!/usr/bin/env python3
"""Where a link of segmentation pass 2 spends its cycles on one GPU, and what
two alternative forms of its segment means cost.

    python3 scripts/pass2_probe.py

Pass 2 (``sylber_tpu_torch/csrc/segment_scan.cu``) walks each chain of mid
boundaries a warp at a time, one link per boundary. The script builds
patched copies of the source beside the package's own build (nvcc, sm_90a,
into a temporary directory) and drives each through ``ops/segment.py``'s
wrapper on the same inputs:

- ``kernel``: the source as it is;
- ``ieee_means``: the segment means by ``__fdiv_rn`` element by element,
  instead of one shared reciprocal with a branch-free range test;
- ``or_range_test``: the shared reciprocal with the range test written with
  ``||`` (zeros, or a numerator between 2^-60 and 2^60), which the compiler
  turns into branches;
- ``stamped``: the source with ``clock64`` stamps around the parts of a link
  (lane 0 of each warp sums them): the loads at the top of a link and the
  wait for the window's first frame, each segment mean, the dot, |a|^2 and
  |b|^2 and their reduction, the square roots, the window's cosines, the
  walk, and the end of the link.

Inputs: B32 L249 d768 of random frames, every frame voiced (the main path at
random weights: one chain a row, 248 links), the same at d 384 and 128, and
``chip_smoke.py``'s phase-2 data (B32 L1000 d768, 131 links the longest
chain). Each form is timed by CUDA-graph replay, in turns (forms in order,
then in reverse), and held to the plain version (segments and counts).
Prints the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PARTS = ["loads + first frame", "mean a", "mean b", "dot/|a|/|b| + reduce", "square roots",
         "window cosines", "walk", "end"]


def variants(src: str) -> dict:
    """The patched copies of segment_scan.cu, by name."""
    start = src.index("  float least = 1.f, most = 0.f;")
    end = src.index("\n}\n", start) + 1
    ieee = """#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int e = 0; e < V; ++e) m[c][e] = __fdiv_rn(__fsub_rn(hi[c][e], lo[c][e]), len);
"""
    or_test = """  bool exact = true;
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int e = 0; e < V; ++e) {
      m[c][e] = __fsub_rn(hi[c][e], lo[c][e]);
      exact &= m[c][e] == 0.f || (fabsf(m[c][e]) >= 0x1p-60f && fabsf(m[c][e]) <= 0x1p60f);
    }
  const Divisor by(len);
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int e = 0; e < V; ++e) m[c][e] = by.divide(m[c][e]);
  if (__any_sync(FULL, !exact)) {
    for (int i = lane; i < d; i += 32) scratch[i] = __fdiv_rn(__fsub_rn(hi_row[i], lo_row[i]), len);
    __syncwarp();
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int i = (c * 32 + lane) * V + e;
        m[c][e] = i < d ? scratch[i] : 0.f;
      }
    __syncwarp();
  }
"""
    anchor = lambda arr: (f'asm volatile("" :: "f"({arr}[0][0]), "f"({arr}[NCH - 1][V - 1]));')  # noqa: E731
    marks = [  # (anchor text, inserted text, before the anchor?)
        ("    const bool more = j + 1 < m && mid_n.y < n - 1 && index(mid_n) == gi + 1;\n",
         "    long long T0 = clock64();\n", True),
        ("    float ma[NCH][V], mb[NCH][V];\n",
         anchor("pa0") + anchor("xw[0]") + " long long T1 = clock64();\n", True),
        ("    segment_mean(ma, pa1, pa0, sa.y - sa.x, row(Pb, sa.y), row(Pb, sa.x), d, scratch, "
         "lane);\n", anchor("ma") + " long long T2 = clock64();\n", False),
        ("    segment_mean(mb, pb1, pb0, sb.y - sb.x, row(Pb, sb.y), row(Pb, sb.x), d, scratch, "
         "lane);\n", anchor("mb") + " long long T3 = clock64();\n", False),
        ("    warp_sum_n(s3);\n",
         'asm volatile("" :: "f"(s3[0]), "f"(s3[1]), "f"(s3[2])); long long T4 = clock64();\n',
         False),
        ("    int2 carry;\n", 'asm volatile("" :: "f"(na), "f"(nb)); long long T5 = clock64();'
         " long long T6 = T5, T7 = T5;\n", True),
        ("      __syncwarp();\n      // every lane walks", "      T6 = clock64();\n", True),
        ("      __syncwarp();  // the next window writes where this one was read\n",
         "      T7 = clock64();\n", False),
        ("    if (!more) return;\n",
         "    if (lane == 0) { long long T8 = clock64(); long long t[8] = {T1 - T0, T2 - T1, "
         "T3 - T2, T4 - T3, T5 - T4, T6 - T5, T7 - T6, T8 - T7}; for (int q = 0; q < 8; ++q) "
         "atomicAdd(&probe_cycles[q], (unsigned long long)t[q]); "
         "atomicAdd(&probe_cycles[9], 1ull); }\n", True),
        ("    mid_n = mid_nn, sb_n = sb_nn;\n",
         "    if (lane == 0) atomicAdd(&probe_cycles[8], (unsigned long long)(clock64() - T0));\n",
         False),
    ]
    stamped = src
    for text, add, before in marks:
        assert text in stamped, text
        stamped = stamped.replace(text, add + text if before else text + add, 1)
    return {"kernel": src, "ieee_means": src[:start] + ieee + src[end:],
            "or_range_test": src[:start] + or_test + src[end:], "stamped": stamped}


def build(out: Path, name: str, text: str):
    """One patched copy built into a library with the wrappers' entry points."""
    from sylber_tpu_torch.kernels import _build

    text = text.replace("namespace {\n", "__device__ unsigned long long probe_cycles[16];\n"
                        "namespace {\n", 1)
    text += ('\nextern "C" void read_probe_cycles(unsigned long long* out) {\n'
             "  cudaMemcpyFromSymbol(out, probe_cycles, sizeof(probe_cycles));\n"
             "  unsigned long long zero[16] = {0};\n"
             "  cudaMemcpyToSymbol(probe_cycles, zero, sizeof(zero));\n}\n")
    src = out / f"{name}.cu"
    src.write_text(text)
    return subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-shared", "-o",
         str(out / f"{name}.so"), str(src), str(_build.CSRC / "errors.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from sylber_tpu_torch.kernels import _build
    from sylber_tpu_torch.ops import segment as seg

    if not torch.cuda.is_available():
        print("pass2_probe: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    out = Path(tempfile.mkdtemp(prefix="pass2_probe_"))
    procs = {name: build(out, name, text)
             for name, text in variants((_build.CSRC / "segment_scan.cu").read_text()).items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"{name}: build failed\n{log[-3000:]}")
            return 1
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        for fn in ("sylber_segment_pass1", "sylber_segment_pass2", "sylber_cuda_error_string"):
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = _build._SIGNATURES[fn]
        lib.read_probe_cycles.argtypes = [ctypes.c_void_p]
        libs[name] = lib

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    cases = []
    for d in (768, 384, 128):
        x = torch.randn(32, 249, d, device=dev, generator=gen)
        cases.append((f"B32 L249 d{d}, every frame voiced", x,
                      torch.ones(32, 249, dtype=torch.bool, device=dev)))
    x = torch.from_numpy(cs.synthetic_states(np.random.RandomState(0), 32, 1000, 768)).to(dev)
    voiced = seg.frame_norms(x) >= 2.6
    voiced[3, 700:] = False
    cases.append(("B32 L1000 d768, chip_smoke.py phase 2", x, voiced.contiguous()))
    timed = [n for n in libs if n != "stamped"]
    for label, x, voiced in cases:
        norms, P = seg.frame_norms(x), seg._prefix_sums(x)
        p1 = seg.Pass1Events(*(t.contiguous() for t in seg.segment_pass1_plain(x, voiced, 0.8)))
        args = (x, norms, P, p1.segs, p1.nseg, p1.mids, p1.nmid, 0.8)
        want = seg.segment_pass2_plain(*args)
        chains = cs.chain_counts(*(t.cpu().numpy() for t in (p1.mids, p1.nseg, p1.nmid)))
        ms = {}
        for name in timed + timed[::-1]:
            seg.lib = lambda lib=libs[name]: lib
            got = seg.segment_pass2(*args)
            bad = int((got[0] != want[0]).sum() + (got[1] != want[1]).sum())
            if bad:
                print(f"{label}: {name} disagrees with the plain version in {bad} entries")
                return 1
            ms.setdefault(name, []).append(cs.graph_time_ms(torch, lambda: seg.segment_pass2(*args),
                                                            5))
        print(f"{label} ({chains['longest_chain']} links the longest chain): "
              + ", ".join(f"{n} {v[0]:.4f} / {v[1]:.4f} ms" for n, v in ms.items()), flush=True)
        lib = libs["stamped"]
        seg.lib = lambda: lib
        cycles = (ctypes.c_ulonglong * 16)()
        seg.segment_pass2(*args)
        torch.cuda.synchronize()
        lib.read_probe_cycles(ctypes.addressof(cycles))  # clears the warm-up's sums
        seg.segment_pass2(*args)
        torch.cuda.synchronize()
        lib.read_probe_cycles(ctypes.addressof(cycles))
        links = cycles[9]
        print(f"  stamped: cycles a link (mean of {links} links): "
              + ", ".join(f"{p} {cycles[i] / links:.0f}" for i, p in enumerate(PARTS))
              + f"; a whole link {cycles[8] / max(links, 1):.0f} (links followed by another)",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
