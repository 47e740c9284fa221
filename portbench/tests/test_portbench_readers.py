"""The per-layer readers: a number from what a run observed, ``None`` where
there is nothing to read, never a share of a roofline above 100 % from the
bounds' arithmetic alone."""

import pytest

from portbench import spec
from portbench.profile import Trace, breakdown, busy_us, summarize
from portbench.reference import hubert as ref_hubert

CFG = spec.config("sylber-base-segmenter-bf16")


def observed(trace):
    frames = lambda n: ref_hubert.num_frames(CFG, n)  # noqa: E731
    return {"spans": {"enqueue": [0.01, 0.03], "finalize": [0.02], "dispatch": [0.8, 0.9]},
            "window_s": 10.0, "audio_s": 30000.0, "flops": 3.7e14, "peak_flops": 989e12,
            "steps": 16, "steps_per_dispatch": 8, "peak_mem_bytes_window": 2 ** 33,
            "traced_calls": [(64, 64000, [60000] * 64)], "config": CFG, "frames": frames,
            "trace": trace}


TRACE = Trace(window_s=2.0, busy_s=1.5, gaps=[("finalize: aten::copy_", 0.01)],
              nccl_busy_s=0.0,
              by_name={"conv0_normalize<bf16>": 1e-3, "conv0_moments": 2e-4,
                       "void attn_mma_kernel<64, 4, 2, 3, false>": 5e-3,
                       "segment_pass1_kernel": 1e-3, "segment_pass2_kernel": 1e-3})


@pytest.mark.parametrize("name", [m["name"] for m in spec.benchmark()["per_layer"]])
def test_reader(name):
    value = spec.reader(name)(observed(TRACE))
    assert value is not None and value > 0
    if "roofline" in name or name.startswith("mfu."):
        assert value <= 100.0
    untraced = spec.reader(name)(observed(None))
    if "roofline" in name or name.startswith("idle_share."):
        assert untraced is None


def test_busy_is_a_union():
    assert busy_us([(0, 10), (5, 15), (20, 30)]) == 25


class _Range:
    def __init__(self, start, end):
        self.start, self.end = start, end


class _Event:
    def __init__(self, name, start, end, cuda):
        import torch

        self.name, self.time_range = name, _Range(start, end)
        self.device_type = (torch.autograd.DeviceType.CUDA if cuda
                            else torch.autograd.DeviceType.CPU)


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_summarize_leaves_out_host_spans_and_labels_gaps():
    prof = _Prof([_Event("k1", 0, 100, True), _Event("k2", 300, 400, True),
                  _Event("portbench.enqueue", 0, 1000, True),
                  _Event("portbench.enqueue", 90, 350, False), _Event("aten::copy_", 120, 260, False)])
    t = summarize(prof, window_s=1e-3)
    assert t.busy_s == pytest.approx(200e-6)
    assert t.gaps == [("enqueue: aten::copy_", pytest.approx(200e-6))]
    assert [n for n, _ in breakdown(t)["device_ops"]] == ["k1", "k2"]
