"""Segmentation pass 2 (a warp per chain of mid boundaries), its CUDA source
run on the CPU.

``segment_scan.cu`` is compiled by g++ against the host stand-in of
``tests/cuda_emu`` (``test_torch_cuda_emu.py``'s helper: every CUDA thread a
host thread, shuffles and barriers emulated) and driven through
``ops/segment.py``'s own launch code. Pass 2 splits a row's mid boundaries
into chains (a boundary depends on the one before only when its segment
index is that one's + 1) and walks them a warp each; the cases cover what
that split meets: chains broken by unvoiced gaps and by skipped boundaries,
one chain a whole row long, a merge at a chain's first boundary, a sweep
window longer than the warp's shared memory holds, one row at d 768, more
chains in a row than warps in a block, rows of a width off the 4-float
loads, and sums past 2^60, which the means' shared reciprocal does not
take (the warp divides with __fdiv_rn). Each is held to the plain version and JAX's ``_pass2`` + ``_compact``
exactly, and checks that its buffers hold what it is named for. Last, both
kernels on the trained mini encoder's hidden states of held-out utterances.

A separate file from ``test_torch_cuda_emu.py`` so that a distributed run can
give it a worker of its own.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sylber_tpu.ops import segment as jax_segment
from sylber_tpu.ops.segment_np import segment_oracle
from sylber_tpu_torch import Segmenter
from sylber_tpu_torch.models.hubert import HubertConfig
from sylber_tpu_torch.ops import segment as port_segment
from test_torch_cuda_emu import _check, _plateaus, build_host_library
from _torch_threads import _few_threads  # noqa: E402,F401 (autouse)

FIXTURES = Path(__file__).parent / "fixtures"
ENTRY_POINTS = ["sylber_segment_pass1", "sylber_segment_pass2"]


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    return build_host_library(tmp_path_factory.mktemp("cuda_emu_pass2"),
                              ("common.cuh", "segment_scan.cu"), ENTRY_POINTS)


@pytest.fixture
def segment_launch(emulated, monkeypatch):
    """The launch halves of ``ops/segment.py``'s wrappers on the host library."""
    monkeypatch.setattr(port_segment, "lib", lambda: emulated)
    monkeypatch.setattr(port_segment, "stream_of", lambda t: 0)
    monkeypatch.setattr(port_segment, "check", _check)
    return port_segment._launch_pass1, port_segment._launch_pass2


def _chain_facts(states, segs, nseg, mids, nmid, thr):
    """What pass 2 meets on these buffers, walked on the host in float32 as the
    plain version walks: per row the lengths of its chains of mid boundaries
    (a boundary continues a chain when its segment index is the previous
    boundary's + 1), the boundaries skipped, the widest sweep window, and
    whether a chain's first boundary merges."""
    def cos(x, y):
        eps = np.float32(1e-8)
        return (x * y).sum(-1) / np.sqrt((x * x).sum(-1) + eps) / np.sqrt((y * y).sum(-1) + eps)

    facts = []
    for b in range(len(states)):
        row = [list(s) for s in segs[b]]
        chains, skipped, widest, first_merge, prev = [], 0, 0, False, None
        for bd, g in mids[b, :nmid[b]]:
            if g >= nseg[b] - 1:
                skipped, prev = skipped + 1, None
                continue
            start = prev is None or g != prev + 1
            chains += [0] if start else []
            chains[-1] += 1
            prev = g
            (a0, a1), (b0, b1) = row[g], row[g + 1]
            ma = states[b, a0:a1].sum(0) / np.float32(max(a1 - a0, 1))
            mb = states[b, b0:b1].sum(0) / np.float32(max(b1 - b0, 1))
            if cos(ma, mb) >= thr:
                row[g + 1] = [a0, b1]
                first_merge |= start
                continue
            ws, we = max(a0, bd - max(1, (a1 - a0) // 2)), min(b1, bd + max(1, (b1 - b0) // 2))
            widest = max(widest, we - ws)
            cp, cn = cos(states[b, ws:we], ma), cos(states[b, ws:we], mb)
            opt = ws + int(np.argmax([cp[:t].sum() + cn[t:].sum() for t in range(we - ws)]))
            row[g], row[g + 1] = [a0, opt], [opt, b1]
        facts.append(dict(chains=chains, skipped=skipped, widest=widest, first_merge=first_merge))
    return facts


def _rotating_row(rng, d):
    """A silence, four frames of p, then a boundary at a frame 40 degrees off p
    whose segment turns back to p in 10-degree steps (so its mean lies near p:
    pass 2 merges the chain's first boundary), then a jump to an unrelated
    direction (the chain's second boundary), (L, d)."""
    p, q = rng.randn(d), rng.randn(d)
    q -= q @ p / (p @ p) * p
    p, q = p / np.linalg.norm(p), q / np.linalg.norm(q)
    turn = lambda deg: 5.0 * (np.cos(np.radians(deg)) * p + np.sin(np.radians(deg)) * q)  # noqa: E731
    s = rng.randn(d)
    s = 5.0 * s / np.linalg.norm(s)
    frames = ([np.zeros(d)] * 3 + [turn(0)] * 4 + [turn(a) for a in (40, 30, 20, 10)]
              + [turn(0)] * 4 + [s] * 5 + [np.zeros(d)] * 2)
    return np.stack(frames) + 0.01 * rng.randn(len(frames), d)


def _pass2_case(name, rng):
    """(states (B, L, d), voiced norm threshold, merge threshold) of a case."""
    if name == "one-chain-all-voiced":   # short plateaus, no gap: one chain a row
        d, rows = 144, []
        for _ in range(2):
            parts = []
            while sum(len(x) for x in parts) < 120:
                proto = rng.randn(d)
                proto *= 5.0 / np.linalg.norm(proto)
                parts.append(proto + 0.3 * rng.randn(int(rng.randint(1, 5)), d))
            rows.append(np.concatenate(parts)[:120])
        return np.stack(rows).astype(np.float32), 1.0, 0.8
    if name == "merge-at-a-chain-start":
        return np.stack([_rotating_row(rng, 144)]).astype(np.float32), 1.0, 0.8
    if name == "window-past-WIN":        # two 150-frame plateaus: a 150-frame window
        d = 144
        a, b = rng.randn(2, d)
        a, b = 5.0 * a / np.linalg.norm(a), 5.0 * b / np.linalg.norm(b)
        x = np.concatenate([a + 0.15 * rng.randn(150, d), b + 0.15 * rng.randn(150, d)])
        return x[None].astype(np.float32), 1.0, 0.8
    if name == "huge-values":  # sums of frames past 2^60: the means' IEEE fallback
        d, parts = 16, []
        while sum(len(x) for x in parts) < 200:
            proto = rng.randn(d)
            proto *= 4.0 / np.linalg.norm(proto)
            parts.append(proto + 0.3 * rng.randn(int(rng.randint(6, 30)), d))
        return (1e17 * np.concatenate(parts)[:200])[None].astype(np.float32), 1e17, 0.8
    if name == "B1-d768":
        return _plateaus(rng, 160, 768)[None], 2.6, 0.8
    if name == "more-chains-than-warps":  # 20 runs of 2-3 plateaus, each after a gap
        d, rows = 144, []
        for _ in range(2):
            parts = []
            for _ in range(20):
                parts.append(np.zeros((2, d)))
                for _ in range(int(rng.randint(2, 4))):
                    proto = rng.randn(d)
                    proto *= 5.0 / np.linalg.norm(proto)
                    parts.append(proto + 0.15 * rng.randn(int(rng.randint(3, 7)), d))
            rows.append(np.concatenate(parts)[:250])
        return np.stack(rows).astype(np.float32), 1.0, 0.8
    if name == "d50-scalar-rows":
        return np.stack([_plateaus(rng, 200, 50) for _ in range(2)]), 2.6, 0.8
    # unvoiced gaps break the chains; the last boundaries of row 0 are skipped
    return np.stack([_plateaus(rng, 200, 144) for _ in range(3)]), 2.6, 0.8


PASS2_CASES = ["gaps-and-skipped-boundaries", "one-chain-all-voiced", "merge-at-a-chain-start",
               "window-past-WIN", "B1-d768", "more-chains-than-warps", "d50-scalar-rows",
               "huge-values"]


@pytest.mark.parametrize("name", PASS2_CASES)
def test_emulated_pass2_chains_match_plain_and_jax(segment_launch, name):
    """Pass 2 (a warp per chain of mid boundaries) on pass 1's buffers against
    its plain version and JAX's ``_pass2`` + ``_compact``: segments and counts
    exactly. Each case checks that its buffers hold what it is named for."""
    _, launch_pass2 = segment_launch
    rng = np.random.RandomState(PASS2_CASES.index(name) + 40)
    states, nt, mt = _pass2_case(name, rng)
    x = torch.from_numpy(states)
    norms = port_segment.frame_norms(x)
    voiced = (norms >= nt).contiguous()
    # the buffers as the CUDA wrapper takes them (contiguous, as pass 1's kernel leaves them)
    p1 = port_segment.Pass1Events(*(t.contiguous() for t in
                                    port_segment.segment_pass1_plain(x, voiced, mt)))
    nseg = p1.nseg.clone()
    if name == "gaps-and-skipped-boundaries":
        nseg[0] -= 3  # the last boundaries of row 0 now close the row's last segment
    facts = _chain_facts(states, p1.segs.numpy(), nseg.numpy(), p1.mids.numpy(),
                         p1.nmid.numpy(), mt)
    chains = [f["chains"] for f in facts]
    if name == "gaps-and-skipped-boundaries":
        assert facts[0]["skipped"] >= 2 and all(len(c) >= 2 for c in chains), facts
    elif name == "one-chain-all-voiced":
        assert bool(voiced.all()) and [c for c in chains] == [[int(n)] for n in p1.nmid], chains
    elif name == "merge-at-a-chain-start":
        assert facts[0]["first_merge"] and chains[0] == [2], facts
    elif name == "window-past-WIN":
        assert facts[0]["widest"] > 64, facts  # csrc/segment_scan.cu: WIN
    elif name == "more-chains-than-warps":
        assert max(len(c) for c in chains) > port_segment.PASS2_WARPS, chains
    elif name == "huge-values":  # a segment's sum past the shared reciprocal's range
        P = port_segment._prefix_sums(x)
        spans = p1.segs[0, :int(nseg[0])].long()
        assert float((P[0, spans[:, 1]] - P[0, spans[:, 0]]).abs().max()) > 2.0 ** 60

    P = port_segment._prefix_sums(x)
    args = (x, norms, P, p1.segs, nseg, p1.mids, p1.nmid, mt)
    segs, n = launch_pass2(*args)
    want_segs, want_n = port_segment.segment_pass2_plain(*args)
    np.testing.assert_array_equal(n.numpy(), want_n.numpy())
    np.testing.assert_array_equal(segs.numpy(), want_segs.numpy())
    jsegs, jalive = jax_segment._pass2(jnp.asarray(states), jnp.asarray(norms.numpy()),
                                       *(jnp.asarray(t.numpy()) for t in
                                         (p1.segs, nseg, p1.mids, p1.nmid)), mt)
    ref_segs, ref_n = jax_segment._compact(jsegs, jnp.asarray(nseg.numpy()), jalive)
    np.testing.assert_array_equal(n.numpy(), np.asarray(ref_n))
    np.testing.assert_array_equal(segs.numpy(), np.asarray(ref_segs))


def test_emulated_segmentation_on_mini_ckpt_held_out(segment_launch):
    """Both kernels on the trained mini encoder's hidden states of three held-out
    utterances (the first three of ``test_torch_segmenter.py``'s fast-vs-exact
    set), batched with padding: the same segments as the plain versions, the
    port's CPU ``Segmenter``, JAX's ``segment_batch`` and the numpy oracle.
    The trained encoder closes its segments at unvoiced frames and puts no
    mid boundary in these utterances, so pass 2 only compacts here: its own
    summation order (``ROADMAP.md`` section 3, intended difference (f)) is
    held by the chain cases above, on rows full of mid boundaries."""
    from test_torch_segmenter import _utterances

    launch_pass1, launch_pass2 = segment_launch
    meta = json.loads((FIXTURES / "mini_ckpt.json").read_text())
    hub = {k: tuple(v) if isinstance(v, list) else v for k, v in meta["hubert"].items()}
    hub["num_hidden_layers"] = meta["encoding_layer"]
    nt, mt = meta["norm_threshold"], meta["merge_threshold"]
    seg = Segmenter(model_ckpt=str(FIXTURES / "mini_ckpt.npz"), hubert_config=HubertConfig(**hub),
                    device="cpu", norm_threshold=nt, merge_threshold=mt)
    wavs = _utterances(lengths_s=tuple(np.random.RandomState(9999).uniform(3.0, 8.0, 16)[:3]))
    outs = seg.process(wavs, in_second=False)
    hidden = [o["hidden_states"].astype(np.float32) for o in outs]
    L = max(len(h) for h in hidden)
    states = np.zeros((len(hidden), L, hidden[0].shape[1]), np.float32)
    valid = np.zeros((len(hidden), L), bool)
    for b, h in enumerate(hidden):
        states[b, :len(h)], valid[b, :len(h)] = h, True

    x = torch.from_numpy(states)
    norms = port_segment.frame_norms(x)
    voiced = ((norms >= nt) & torch.from_numpy(valid)).contiguous()
    p1 = launch_pass1(x, voiced, mt)
    segs, n = launch_pass2(x, norms, port_segment._prefix_sums(x), p1.segs, p1.nseg, p1.mids,
                           p1.nmid, mt)
    plain = port_segment.segment_batch(x, nt, mt, frame_valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(n.numpy(), plain.num_segments.numpy())
    np.testing.assert_array_equal(segs.numpy(), plain.segments.numpy())
    ref = jax_segment.segment_batch(jnp.asarray(states), nt, mt, frame_valid=jnp.asarray(valid))
    np.testing.assert_array_equal(segs.numpy(), np.asarray(ref.segments))
    for b, o in enumerate(outs):
        assert segs[b, :int(n[b])].numpy().tolist() == o["segments"].tolist()
        assert segs[b, :int(n[b])].numpy().tolist() == segment_oracle(hidden[b], nt, mt).tolist()
    assert int(n.sum()) > 15
