"""The seeding kernel's CUDA source at the widths past its shared center, run
on the CPU.

``kmeanspp.cu`` is compiled by g++ against the host stand-in of
``tests/cuda_emu`` (``test_torch_cuda_emu.py``'s helper: every CUDA thread a
host thread, the cooperative launch on a card of 3 SMs with the H100's
232,448 bytes of shared memory a block, the flag words emulated) and driven
through ``flow/kmeans.py``'s launch code. Held against ``kmeanspp_plain`` on
the same uniforms, rows and centers exactly equal:

- d 4,100, past the 4,096 the kernel once refused: the center in shared
  memory, a few of a block's rows resident;
- d 57,000: the widest class whose center still fits, no row resident;
- d 58,001 and 60,000: the center past a block's shared memory, read from
  exchange 2's flag words (scalar and float4 loads);

and the plan's refusals against :func:`seeding_refusal`'s, at the last
row count a block's weights fit and the next, and past ``MAX_WIDTH``.

A file of its own, so that ``test_torch_cuda_emu.py`` keeps its time and a
distributed run can give this one a worker.
"""

import ctypes

import numpy as np
import pytest
import torch

from sylber_tpu_torch.flow import kmeans as port_kmeans
from test_torch_cuda_emu import _check, build_host_library

ENTRY_POINTS = ["sylber_kmeanspp_scratch", "sylber_kmeanspp", "sylber_kmeanspp_barrier_probe"]
EMU_SMS, EMU_OPTIN = 3, 232448  # tests/cuda_emu/cuda_runtime.h


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    return build_host_library(tmp_path_factory.mktemp("cuda_emu_kmeans_wide"),
                              names=("common.cuh", "kmeanspp.cu"), entry_points=ENTRY_POINTS)


@pytest.fixture
def kmeanspp_launch(emulated, monkeypatch):
    """``flow/kmeans.py``'s launch code, bound to the host library."""
    monkeypatch.setattr(port_kmeans, "lib", lambda: emulated)
    monkeypatch.setattr(port_kmeans, "stream_of", lambda t: 0)
    monkeypatch.setattr(port_kmeans, "check", _check)
    return port_kmeans._launch


def _plan(emulated, n, d, min_rows, max_threads):
    plan = (ctypes.c_int * len(port_kmeans._PLAN_KEYS))()
    size = emulated.sylber_kmeanspp_scratch(n, d, min_rows, max_threads, -1, plan)
    return size, dict(zip(port_kmeans._PLAN_KEYS, plan))


WIDE_CASES = [
    # name, rows, width, centers, the fewest rows a block, a block's most threads, the
    # center in shared memory, rows resident a block
    ("d4100", 96, 4100, 8, 32, 64, 1, 13),
    ("d57000-widest-shared", 96, 57000, 6, 32, 64, 1, 0),
    ("d58001-center-from-words", 96, 58001, 6, 32, 64, 0, 0),
    ("d60000-center-from-words", 96, 60000, 6, 32, 64, 0, 0),
]


@pytest.mark.parametrize("name,n,d,k,min_rows,max_threads,shared,resident", WIDE_CASES,
                         ids=[c[0] for c in WIDE_CASES])
def test_emulated_wide_kmeanspp_matches_plain(kmeanspp_launch, emulated, name, n, d, k,
                                              min_rows, max_threads, shared, resident):
    """The seeding at each width class against ``kmeanspp_plain`` on the
    same uniforms: the same rows and centers exactly (a row may differ only
    where a uniform lands within float64 rounding of a prefix boundary;
    none does here), on a grid of three blocks, each exchange's words read
    by every block."""
    size, plan = _plan(emulated, n, d, min_rows, max_threads)
    assert size > 0
    assert (plan["grid"], plan["shared_center"], plan["resident_rows_per_block"]) == (
        3, shared, resident)
    rng = np.random.RandomState(d + k)
    # clusters of several spreads: the distances differ widely, so that a wrong
    # center moves the draws (at this width, unit Gaussian rows are all about
    # equally far apart, and any center draws nearly the same rows)
    means = rng.randn(8, d) * 2
    x = means[rng.randint(0, 8, n)] + rng.randn(n, d) * rng.uniform(0.1, 1.5, (n, 1))
    x = torch.from_numpy(x.astype(np.float32))
    u = port_kmeans.seeding_uniforms(d + k, k)
    centers, rows = kmeanspp_launch(x, u, -1, min_rows, max_threads)
    want_centers, want_rows = port_kmeans.kmeanspp_plain(x, u)
    np.testing.assert_array_equal(rows.numpy(), want_rows.numpy())
    torch.testing.assert_close(centers, want_centers, rtol=0, atol=0)
    assert len(set(rows.tolist())) == k


def test_emulated_plan_refuses_where_the_wrapper_does(emulated):
    """The plan's refusals are :func:`seeding_refusal`'s on the stand-in's
    card: the last row count whose weights a block holds is taken and the
    next refused, at a narrow and a wide width, and a width past
    ``MAX_WIDTH`` is refused."""
    # 3 blocks of 19,320 rows: 576 + 12 x 19,320 = 232,416 bytes; one row more
    # makes a block's row count 19,321, whose stride of 19,324 rows is past
    last = 3 * 19320
    for d in (8, 60000):
        assert port_kmeans.seeding_refusal(last, d, EMU_SMS, EMU_OPTIN) is None
        assert _plan(emulated, last, d, 64, 1024)[0] > 0
        why = port_kmeans.seeding_refusal(last + 1, d, EMU_SMS, EMU_OPTIN)
        assert why and "19321 a block" in why
        assert _plan(emulated, last + 1, d, 64, 1024)[0] == -1
    wide = port_kmeans.MAX_WIDTH + 1
    assert "past the kernel's" in port_kmeans.seeding_refusal(4, wide, EMU_SMS, EMU_OPTIN)
    assert _plan(emulated, 4, wide, 64, 1024)[0] == -1
    assert _plan(emulated, 4, port_kmeans.MAX_WIDTH, 64, 1024)[0] > 0
