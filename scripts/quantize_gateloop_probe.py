#!/usr/bin/env python3
"""Times the int8 row quantizer and the GateLoop kernel on one GPU: two trees
in turns, and patched forms of the current sources.

    python3 scripts/quantize_gateloop_probe.py [--parent DIR [--segmenter]] [--forms]

- ``--tree DIR`` (what the other modes run in subprocesses): import
  ``sylber_tpu_torch`` from ``DIR`` (its kernels built into ``DIR/build``)
  and print one JSON line of kernel times: ``quantize_rows`` at
  ``chip_smoke.py``'s phase-9 shapes (the encoder's activations, M 7,968 and
  31,968, K 768 and 3,072, float32 and bfloat16) and ``gate_loop_operator``
  at ``GATELOOP_SHAPES`` (thirds of one (B, L, 3D) product), each by
  CUDA-graph replay of 20 launches; with ``--segmenter`` also the bf16 fast
  and int8 + bf16 Segmenters (full width, seeded random weights) on phase
  3's 32 x 5 s and 32 x 12-20 s batches: RTFx (median, least and most of
  five calls) and, over one profiled call (``chip_smoke.profile``), the
  device's busy time without the copies and the quantize and int8 GEMM
  kernels' times;
- ``--parent DIR``: the package of another tree (say, the parent commit's,
  unpacked with ``git archive``) against this one on the same card, in the
  order parent, this, this, parent;
- ``--forms``: patched copies of this tree's sources, built beside the
  package (nvcc, sm_90a, into a temporary directory) and driven through the
  wrappers: the quantizer's grid of a warp a row (the source) and a
  persistent grid of 1, 2, 4 and 8 blocks an SM; the GateLoop block at 8,
  16 and 32 warps (1 to 4 chunks a warp), and with the block's rows asked
  into L2 (bulk prefetches) before its loads. Each form is held bit for bit
  to the plain version before it is timed, in turns (forms in order, then
  in reverse). Then the GateLoop
  source with ``clock64`` stamps (lane 0 of each warp sums them over its
  segments): the loads and phase 1, the wait at the first barrier, phase 2
  and the second barrier, phase 3 (its stores issued), at each shape.

Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

QUANT_SHAPES = [(M, K) for M in (7968, 31968) for K in (768, 3072)]
GATELOOP_SHAPES = [(8, 265, 512), (1, 1015, 512)]


def kernel_times(torch, i8, gl, graph_time_ms) -> dict:
    """ms of each quantize and GateLoop shape through the wrappers."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    out = {}
    for M, K in QUANT_SHAPES:
        for dt in ("float32", "bfloat16"):
            x = torch.randn(M, K, device=dev, generator=gen).to(getattr(torch, dt))
            q, s = i8.quantize_rows(x)
            pq, ps = i8.quantize_symmetric_plain(x)
            if not (torch.equal(q, pq) and torch.equal(s, ps[:, 0])):
                raise AssertionError(f"quantize_rows {dt} {M}x{K} differs from the plain version")
            out[f"quantize {dt} {M}x{K}"] = graph_time_ms(torch, lambda: i8.quantize_rows(x), 20)
    for B, L, D in GATELOOP_SHAPES:
        q, kv, g = torch.randn(B, L, 3 * D, device=dev, generator=gen).chunk(3, dim=-1)
        a = torch.sigmoid(g)
        if not torch.equal(gl.gate_loop_operator(q, kv, a), gl.gate_loop_operator_plain(q, kv, a)):
            raise AssertionError(f"gate_loop_operator B{B} L{L} D{D} differs from the plain "
                                 "version")
        out[f"gate_loop B{B} L{L} D{D}"] = graph_time_ms(
            torch, lambda: gl.gate_loop_operator(q, kv, a), 20)
    return out


def segmenter_times(torch, Segmenter, HubertConfig, cs) -> dict:
    """The bf16 and int8 + bf16 Segmenters on phase 3's two batches."""
    import numpy as np

    rng = np.random.RandomState(1)  # chip_smoke.main_path's batches
    batches = {"32x5s": [cs.speechlike(rng, 5 * 16000) for _ in range(32)],
               "32x12-20s": [cs.speechlike(rng, int(rng.uniform(12, 20) * 16000))
                             for _ in range(32)]}
    fast = dict(dtype="bfloat16", frontend_dtype="bfloat16", precision="default")
    out = {}
    for mode, cfg in (("bf16", HubertConfig(**fast)),
                      ("int8", HubertConfig(int8_encoder=True, **fast))):
        seg = Segmenter(hubert_config=cfg)
        for bname, wavs in batches.items():
            seg.process(wavs, in_second=False)  # warm-up
            torch.cuda.synchronize()
            walls = []
            for _ in range(5):
                t0 = time.perf_counter()
                seg.process(wavs, in_second=False)
                walls.append(time.perf_counter() - t0)
            rtfx = sorted(sum(len(w) for w in wavs) / 16000.0 / w for w in walls)
            prof = cs.profile(torch, lambda: seg.process(wavs, in_second=False))
            ours = prof["port_kernels_ms"]
            out[f"{mode} {bname}"] = dict(
                rtfx=rtfx[2], rtfx_min=rtfx[0], rtfx_max=rtfx[-1],
                kernel_busy_ms=prof["kernel_busy_ms"], device_ms=prof["device_ms"],
                quantize_ms=sum(v for k, v in ours.items() if "quantize" in k),
                int8_gemm_ms=sum(v for k, v in ours.items() if "int8_gemm" in k))
        del seg
        torch.cuda.empty_cache()
    return out


def tree_times(tree: Path, segmenter: bool) -> dict:
    import torch

    sys.path.insert(0, str(tree))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs  # noqa: E402
    from sylber_tpu_torch import Segmenter  # noqa: E402
    from sylber_tpu_torch.models.hubert import HubertConfig  # noqa: E402
    from sylber_tpu_torch.ops import gateloop as gl  # noqa: E402
    from sylber_tpu_torch.ops import int8 as i8  # noqa: E402

    assert Path(i8.__file__).resolve().is_relative_to(tree.resolve()), i8.__file__
    out = {"kernels": kernel_times(torch, i8, gl, cs.graph_time_ms)}
    if segmenter:
        out["segmenter"] = segmenter_times(torch, Segmenter, HubertConfig, cs)
    return out


def run_tree(tree: Path, segmenter: bool) -> dict:
    done = subprocess.run([sys.executable, __file__, "--tree", str(tree)]
                          + ["--segmenter"] * segmenter, capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"{tree}: exit {done.returncode}\n{done.stdout[-2000:]}"
                           f"{done.stderr[-4000:]}")
    return json.loads(done.stdout.strip().splitlines()[-1])


def patched(src: str, old: str, new: str) -> str:
    assert src.count(old) == 1, old
    return src.replace(old, new)


def forms() -> dict:
    """name -> (file, patched text) of every form."""
    from sylber_tpu_torch.kernels import _build

    quant = (_build.CSRC / "int8_gemm.cu").read_text()
    grid = "  const int grid = ceil_div(R, Q_THREADS / 32);  // a warp a row\n"
    out = {"quantize_warp_a_row": ("int8_gemm.cu", quant)}
    for n in (1, 2, 4, 8):  # persistent: n blocks an SM, rows dealt to the warps in turn
        out[f"quantize_{n}_blocks_an_sm"] = ("int8_gemm.cu", patched(quant, grid, (
            "  int device = 0, sms = 0;\n  cudaGetDevice(&device);\n"
            "  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);\n"
            f"  const int grid = min(ceil_div(R, Q_THREADS / 32), sms * {n});\n")))
    gate = (_build.CSRC / "gateloop.cu").read_text()
    for warps, cpw in ((8, 4), (16, 2), (32, 1), (16, 1)):
        text = patched(gate, "constexpr int WARPS = 16;", f"constexpr int WARPS = {warps};")
        out[f"gateloop_{warps}_warps_{cpw}_chunks"] = ("gateloop.cu", patched(
            text, "constexpr int CPW = 1;", f"constexpr int CPW = {cpw};"))
    out["gateloop_l2_prefetch"] = ("gateloop.cu", patched(gate, L2_ANCHOR, L2_PREFETCH + L2_ANCHOR))
    out["gateloop_stamped"] = ("gateloop.cu", stamped(gate))
    return out


# the block's rows of q, kv and a asked into L2 (bulk prefetches of 128 bytes,
# the D 512 shapes' rows are 128-byte aligned) before any load
L2_ANCHOR = "  float carry = 0.f;  // warp 0: the state entering the segment\n"
L2_PREFETCH = "  for (int t = threadIdx.x; t < L; t += THREADS) {\n" + "".join(
    f'    asm volatile("cp.async.bulk.prefetch.L2.global [%0], 128;" ::"l"({p} - lane + t * {st})'
    ' : "memory");\n' for p, st in (("qc", "qt"), ("kc", "kt"), ("ac", "at"))) + "  }\n"


STAMP_PARTS = ["loads + phase 1", "first barrier", "phase 2 + second barrier", "phase 3"]


def stamped(src: str) -> str:
    """gateloop.cu with clock64 stamps around the parts of a segment."""
    marks = [  # (anchor, inserted text, before the anchor?)
        ("    float qv[CPW][CH], kvv[CPW][CH], av[CPW][CH];\n",
         "    long long T0 = clock64();\n", True),
        ("#pragma unroll\n    for (int i = 0; i < CPW; ++i) ps[warp",
         '    asm volatile("" :: "f"(s[0]), "f"(p[0]));\n    long long T1 = clock64();\n', True),
        ("    __syncthreads();\n    // phase 2", "    long long T2 = clock64();\n", False),
        ("    __syncthreads();\n    // phase 3", "    long long T3 = clock64();\n", False),
        ("    // the next segment writes ps only",
         '    asm volatile("" :: "f"(s[0]));\n'
         "    if (lane == 0) {\n      long long T4 = clock64();\n"
         "      long long t[4] = {T1 - T0, T2 - T1, T3 - T2, T4 - T3};\n"
         "      for (int k = 0; k < 4; ++k)\n"
         "        atomicAdd(&probe_cycles[k], (unsigned long long)t[k]);\n"
         "      atomicAdd(&probe_cycles[4], 1ull);\n    }\n", True),
    ]
    for anchor, add, before in marks:
        if not before:
            i = src.index(anchor) + src[src.index(anchor):].index("\n") + 1
            src = src[:i] + add + src[i:]
        else:
            assert src.count(anchor) == 1, anchor
            src = src.replace(anchor, add + anchor)
    src = src.replace("namespace gl {\n", "namespace gl {\n__device__ unsigned long long "
                      "probe_cycles[16];\n", 1)
    return src + ('\nextern "C" void read_probe_cycles(unsigned long long* out) {\n'
                  "  cudaMemcpyFromSymbol(out, sylber::gl::probe_cycles, 16 * 8);\n"
                  "  unsigned long long zero[16] = {0};\n"
                  "  cudaMemcpyToSymbol(sylber::gl::probe_cycles, zero, sizeof(zero));\n}\n")


def build_forms(out: Path):
    from sylber_tpu_torch.kernels import _build

    procs = {}
    for name, (file, text) in forms().items():
        src = out / f"{name}.cu"
        src.write_text(text)
        procs[name] = (file, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-shared", "-o",
             str(out / f"{name}.so"), str(src), str(_build.CSRC / "errors.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (file, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: build failed\n{log[-3000:]}")
        regs = re.findall(r"Used (\d+) registers", log)
        print(f"{name}: built ({file}); registers a thread {sorted(set(regs))}", flush=True)
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        for fn in ("sylber_quantize_rows", "sylber_int8_gemm", "sylber_gate_loop",
                   "sylber_cuda_error_string"):  # those the form's sources define
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes, getattr(lib, fn).restype = _build._SIGNATURES[fn]
        libs[name] = (file, lib)
    return libs


def time_forms() -> None:
    import torch

    sys.path.insert(0, str(ROOT))
    from chip_smoke import graph_time_ms
    from sylber_tpu_torch.ops import gateloop as gl
    from sylber_tpu_torch.ops import int8 as i8

    libs = build_forms(Path(tempfile.mkdtemp(prefix="quantize_gateloop_probe_")))
    stamps = libs.pop("gateloop_stamped")[1]
    times = {}
    names = list(libs)
    for name in names + names[::-1]:
        file, lib = libs[name]
        mod = i8 if file == "int8_gemm.cu" else gl
        mod.lib = lambda lib=lib: lib
        got = kernel_times(torch, i8, gl, graph_time_ms)
        keep = {k: v for k, v in got.items() if k.startswith("quantize" if mod is i8 else "gate")}
        for k, v in keep.items():
            times.setdefault(name, {}).setdefault(k, []).append(v)
    for name, rec in times.items():
        print(f"{name}: " + ", ".join(f"{k} {v[0]:.4f} / {v[1]:.4f} ms" for k, v in rec.items()),
              flush=True)
    gl.lib = lambda: stamps
    stamps.read_probe_cycles.argtypes = [ctypes.c_void_p]
    cycles = (ctypes.c_ulonglong * 16)()
    dev = torch.device("cuda")
    parts = {}
    for B, L, D in GATELOOP_SHAPES:
        q, kv, g = torch.randn(B, L, 3 * D, device=dev).chunk(3, dim=-1)
        a = torch.sigmoid(g)
        gl.gate_loop_operator(q, kv, a)
        torch.cuda.synchronize()
        stamps.read_probe_cycles(ctypes.addressof(cycles))  # clears the warm-up's sums
        gl.gate_loop_operator(q, kv, a)
        torch.cuda.synchronize()
        stamps.read_probe_cycles(ctypes.addressof(cycles))
        n = max(cycles[4], 1)
        parts[f"B{B} L{L} D{D}"] = {k: cycles[i] / n for i, k in enumerate(STAMP_PARTS)}
        print(f"gateloop B{B} L{L} D{D}: cycles a warp and segment ({cycles[4]} of them): "
              + ", ".join(f"{k} {cycles[i] / n:.0f}" for i, k in enumerate(STAMP_PARTS)),
              flush=True)
    print(json.dumps({"forms": times, "gateloop_cycles": parts}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, help="time this tree's package alone (one JSON line)")
    ap.add_argument("--parent", type=Path, help="time another tree's package against this one")
    ap.add_argument("--segmenter", action="store_true",
                    help="with --tree or --parent: also the bf16 and int8 Segmenters")
    ap.add_argument("--forms", action="store_true", help="time patched forms of the sources")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("quantize_gateloop_probe: no CUDA device", file=sys.stderr)
        return 2
    if args.tree:
        print(json.dumps(tree_times(args.tree, args.segmenter)))
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    if args.parent:
        order = [("parent", args.parent), ("this", ROOT), ("this", ROOT), ("parent", args.parent)]
        runs = [(name, run_tree(tree, args.segmenter)) for name, tree in order]
        for key in runs[0][1]["kernels"]:
            print(f"{key}: " + ", ".join(f"{name} {r['kernels'][key]:.4f}" for name, r in runs)
                  + " ms", flush=True)
        for key, rec in runs[0][1].get("segmenter", {}).items():
            for metric in rec:
                print(f"{key} {metric}: " + ", ".join(
                    f"{name} {r['segmenter'][key][metric]:.4f}" for name, r in runs), flush=True)
        print(json.dumps({"ab": [{"tree": n, **r} for n, r in runs]}))
    if args.forms:
        time_forms()
    return 0


if __name__ == "__main__":
    sys.exit(main())
