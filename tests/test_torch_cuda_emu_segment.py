"""The segmentation kernels' CUDA source (``segment_scan.cu``: pass 1's scan,
pass 2, the shared-divisor division of ``common.cuh``) run on the CPU.

The sources are compiled by g++ against the host stand-in of
``tests/cuda_emu`` (``test_torch_cuda_emu.py``'s ``build_host_library``:
every CUDA thread a fiber on the host, shuffles and barriers emulated) and
driven through ``ops/segment.py``'s own launch code. Both kernels are held
to their plain versions (events, buffers, segments and counts exactly), the
numpy oracle and the JAX ``segment_batch``; pass 1 at a cosine on its
threshold; both kernels given the merge threshold in memory.

A separate file from ``test_torch_cuda_emu.py`` so that a distributed run can
give it a worker of its own; the segmentation cases of 384 features and more
are in ``test_torch_cuda_emu_segment_wide.py`` for the same reason.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sylber_tpu.ops import segment as jax_segment
from sylber_tpu.ops.segment_np import segment_oracle
from sylber_tpu_torch.ops import segment as port_segment
from test_torch_cuda_emu import _check, _plateaus, _quirk_rows, build_host_library
from _torch_threads import _few_threads  # noqa: E402,F401 (autouse)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The kernel library built for the host, with the C entry points typed."""
    return build_host_library(tmp_path_factory.mktemp("cuda_emu"))


@pytest.mark.parametrize("divisors", ["frame counts"])
def test_shared_divisor_division_is_the_ieee_division(emulated, divisors):
    """``Divisor`` of ``common.cuh`` (one reciprocal, then estimate, remainder
    and correction per numerator) gives the bits of ``x / c`` for the frame
    counts the scan divides by, as ``(curr * cnt + x) / (cnt + 1)`` needs.
    The GPU's reciprocal seed is emulated by a rounded ``1 / c``, so this holds
    the steps after the seed; ``chip_smoke.py`` checks the real one."""
    rng = np.random.RandomState(0)
    c = np.concatenate([np.arange(1, 4002), rng.randint(1, 4002, 40000)]).astype(np.float32)
    x = (rng.randn(c.size) * np.exp(rng.uniform(-12, 8, c.size))).astype(np.float32)
    q, r = np.empty_like(x), np.empty_like(x)
    _check(emulated.sylber_shared_divisor(x.ctypes.data, c.ctypes.data, q.ctypes.data,
                                          r.ctypes.data, c.size, 0), "shared_divisor")
    np.testing.assert_array_equal(r.view(np.int32), (np.float32(1) / c).view(np.int32))
    np.testing.assert_array_equal(q.view(np.int32), (x / c).view(np.int32))


@pytest.fixture
def segment_launch(emulated, monkeypatch):
    """The launch halves of ``ops/segment.py``'s wrappers on the host library."""
    monkeypatch.setattr(port_segment, "lib", lambda: emulated)
    monkeypatch.setattr(port_segment, "stream_of", lambda t: 0)
    monkeypatch.setattr(port_segment, "check", _check)
    return port_segment._launch_pass1, port_segment._launch_pass2


SEGMENT_CASES = [
    # name, seed, L, d, valid lengths
    ("d144", 0, 150, 144, [150, 97, 5]),
    ("d144-ring-wraps", 9, 260, 144, [260, 131]),       # 8 blocks of 32 frames, 8 ring turns
    ("d768-L50", 1, 50, 768, [50, 19]),
    ("d768-L90", 1, 90, 768, [90, 61]),
    ("d768-padded", 2, 90, 768, [90, 33]),
    ("d768-L70", 5, 70, 768, [70, 70]),
    ("d50-scalar-copies", 3, 100, 50, [100, 100, 42]),
    ("d1024", 4, 40, 1024, [40]),                       # three chunks a thread
    ("d384-one-chunk-a-thread", 6, 40, 384, [40, 40]),  # the widest frame of one chunk
    ("d388-two-chunks-a-thread", 6, 40, 388, [40, 23]),
    ("quirk-empty-every-frame", 7, 12, 16, [12, 12, 12]),
    ("one-frame", 8, 1, 144, [1, 0]),
    ("one-long-plateau", 10, 200, 144, [200, 200]),     # the merged mean at counts up to 200
]


# the cases of 384 features and more: test_torch_cuda_emu_segment_wide.py
WIDE = ("d768-L50", "d768-L90", "d768-padded", "d768-L70", "d1024", "d384-one-chunk-a-thread",
        "d388-two-chunks-a-thread")
NARROW_CASES = [c for c in SEGMENT_CASES if c[0] not in WIDE]


@pytest.mark.parametrize("name,seed,L,d,lens", NARROW_CASES, ids=[c[0] for c in NARROW_CASES])
def test_emulated_segmentation_matches_oracle_and_jax(segment_launch, name, seed, L, d, lens):
    check_segmentation(segment_launch, name, seed, L, d, lens)


def check_segmentation(segment_launch, name, seed, L, d, lens):
    """Both segmentation kernels against their plain versions (events, buffers,
    segments and counts exactly), the numpy oracle and the JAX ``segment_batch``."""
    launch_pass1, launch_pass2 = segment_launch
    rng = np.random.RandomState(seed)
    if name.startswith("quirk"):
        states, nt, mt = _quirk_rows(rng), 1.0, 0.8
    elif name == "one-long-plateau":  # every frame voiced, nearly all merge
        proto = rng.randn(len(lens), 1, d) * 0.5
        states = (proto + rng.randn(len(lens), L, d) * 0.15).astype(np.float32)
        nt, mt = 1.0, 0.85
    else:
        states = np.stack([_plateaus(rng, L, d) for _ in lens])
        nt, mt = float(rng.uniform(1.5, 3.5)), float(rng.uniform(0.6, 0.95))
    valid = np.arange(L)[None, :] < np.asarray(lens)[:, None]

    x = torch.from_numpy(states)
    norms = port_segment.frame_norms(x)
    voiced = ((norms >= nt) & torch.from_numpy(valid)).contiguous()
    P = port_segment._prefix_sums(x)
    got1 = launch_pass1(x, voiced, mt)
    want1 = port_segment.segment_pass1_plain(x, voiced, mt)
    for field, g, w in zip(got1._fields, got1, want1):
        assert g.shape == w.shape, field
        np.testing.assert_array_equal(g.int().numpy(), w.int().numpy(), err_msg=field)
    if name.startswith("quirk"):
        assert got1.nseg.tolist()[1:] == [0, 12] and got1.nmid.tolist()[1:] == [0, 11]

    segs, n = launch_pass2(x, norms, P, got1.segs, got1.nseg, got1.mids, got1.nmid, mt)
    want_segs, want_n = port_segment.segment_pass2_plain(
        x, norms, P, want1.segs, want1.nseg, want1.mids, want1.nmid, mt)
    np.testing.assert_array_equal(n.numpy(), want_n.numpy())
    np.testing.assert_array_equal(segs.numpy(), want_segs.numpy())
    ref = jax_segment.segment_batch(jnp.asarray(states), nt, mt, frame_valid=jnp.asarray(valid))
    np.testing.assert_array_equal(n.numpy(), np.asarray(ref.num_segments))
    np.testing.assert_array_equal(segs.numpy(), np.asarray(ref.segments))
    for b, length in enumerate(lens):
        oracle = segment_oracle(states[b, :length], nt, mt)
        assert segs[b, :int(n[b])].numpy().tolist() == oracle.tolist()


@pytest.mark.parametrize("second,above", [((1, 2), False), ((1, 4), True)],
                         ids=["on-the-threshold", "one-ulp-above"])
def test_emulated_pass1_decides_a_cosine_at_the_threshold_exactly(segment_launch, second, above):
    """The scan kernel decides from an estimate of the cosine unless the
    estimate is within 1e-5 of the threshold; there the IEEE quotient must
    decide. Frames of small integers make every sum exact in any order, so
    the cosine of frames 0 and 1 is the same float everywhere: with the
    threshold on it the frames merge (``>=``), one ulp above they do not.
    With (1, 1) and (1, 2) the estimate lies below the quotient, with (1, 1)
    and (1, 4) an ulp above it, so the estimate alone would decide wrongly."""
    launch_pass1, _ = segment_launch
    states = np.zeros((1, 6, 8), np.float32)
    states[0, :, :2] = [(1, 1), second] * 3
    eps = np.float32(1e-8)
    dot, xx = np.float32(1 + second[1]), np.float32(1 + second[1] ** 2)
    cosine = dot / np.sqrt(np.float32(2) + eps) / np.sqrt(xx + eps)
    estimate = (dot * (np.float32(1) / np.sqrt(xx + eps))) * (
        np.float32(1) / np.sqrt(np.float32(2) + eps))
    thr = np.nextafter(cosine, np.float32(2)) if above else cosine
    assert (estimate >= thr) != (cosine >= thr)  # the estimate alone is wrong here
    x = torch.from_numpy(states)
    voiced = torch.ones(1, 6, dtype=torch.bool)
    got = launch_pass1(x, voiced, float(thr))
    want = port_segment.segment_pass1_plain(x, voiced, float(thr))
    for field, g, w in zip(got._fields, got, want):
        np.testing.assert_array_equal(g.int().numpy(), w.int().numpy(), err_msg=field)
    assert bool(got.boundary[0, 1]) == above


THRESHOLD_CASES = [c for c in SEGMENT_CASES if c[0] in ("d768-L50", "one-frame")]


@pytest.mark.parametrize("name,seed,L,d,lens", THRESHOLD_CASES, ids=[c[0] for c in THRESHOLD_CASES])
def test_emulated_segmentation_reads_the_threshold_from_memory(segment_launch, name, seed, L,
                                                               d, lens):
    """Both kernels given the merge threshold as a pointer to one float32 (a
    0-d tensor on the states' device, as the trainer passes it) against the
    same kernels given the number, the plain versions and JAX's
    ``segment_batch``: the same events, buffers and segments, bit for bit,
    for a threshold that float32 does not hold exactly."""
    launch_pass1, launch_pass2 = segment_launch
    rng = np.random.RandomState(seed)
    states = np.stack([_plateaus(rng, L, d) for _ in lens])
    nt, mt = float(rng.uniform(1.5, 3.5)), float(rng.uniform(0.6, 0.95)) + 1e-12
    valid = np.arange(L)[None, :] < np.asarray(lens)[:, None]
    x = torch.from_numpy(states)
    norms = port_segment.frame_norms(x)
    voiced = ((norms >= nt) & torch.from_numpy(valid)).contiguous()
    P = port_segment._prefix_sums(x)
    thr = torch.tensor(mt, dtype=torch.float32)
    assert port_segment.kernel_threshold("t", thr, x) == (0.0, thr.data_ptr())
    got1, num1 = launch_pass1(x, voiced, thr), launch_pass1(x, voiced, mt)
    want1 = port_segment.segment_pass1_plain(x, voiced, thr)
    for field, g, n, w in zip(got1._fields, got1, num1, want1):
        np.testing.assert_array_equal(g.int().numpy(), n.int().numpy(), err_msg=field)
        np.testing.assert_array_equal(g.int().numpy(), w.int().numpy(), err_msg=field)
    segs, n = launch_pass2(x, norms, P, got1.segs, got1.nseg, got1.mids, got1.nmid, thr)
    segs_num, n_num = launch_pass2(x, norms, P, got1.segs, got1.nseg, got1.mids, got1.nmid, mt)
    want_segs, want_n = port_segment.segment_pass2_plain(
        x, norms, P, want1.segs, want1.nseg, want1.mids, want1.nmid, thr)
    for a in (segs_num, want_segs):
        np.testing.assert_array_equal(segs.numpy(), a.numpy())
    for a in (n_num, want_n):
        np.testing.assert_array_equal(n.numpy(), a.numpy())
    ref = jax_segment.segment_batch(jnp.asarray(states), nt, mt, frame_valid=jnp.asarray(valid))
    np.testing.assert_array_equal(segs.numpy(), np.asarray(ref.segments))
    np.testing.assert_array_equal(n.numpy(), np.asarray(ref.num_segments))


