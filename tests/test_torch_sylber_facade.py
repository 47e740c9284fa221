"""The port's ``Sylber`` façade (``sylber_tpu_torch/models/sylber.py``)
against ``sylber_tpu/models/sylber.py`` on two layers of the trained
``mini_ckpt.npz``, fp32 at ``highest``, on the CPU. Nothing in these calls
draws (an empty merge-threshold range, no masking, no noise), so both
façades see the same inputs.

- ``segment``: the student's states within 2e-4, the segments equal, the
  segment features within 2e-4.
- ``forward`` online (stage 2) and with given segments (stage 1): the
  distillation loss within rtol 1e-5, the segment count equal, the updated
  thresholder within rtol 1e-5; the loss carries its graph to the student.
- ``ema_step``: the first call snapshots the student, the second decays
  toward it, as JAX's ``ema_update``.
"""

import jax
import numpy as np
import pytest
import torch

from sylber_tpu.models import hubert as jax_hubert
from sylber_tpu.models.sylber import Sylber as JaxSylber
from sylber_tpu.train.ema import ema_update as jax_ema_update
from sylber_tpu_torch.io.checkpoint import jax_params_from_state_dict, state_dict_from_jax_params
from sylber_tpu_torch.models import hubert as port_hubert
from sylber_tpu_torch.models.sylber import Sylber
from test_torch_distill import THR, _batch, _few_threads, _hub, mini_weights  # noqa: E402,F401

KW = dict(segment_online=True, thresholder_configs=THR, merge_threshold_range=(0.8, 0.8),
          ema_decay=0.9)


@pytest.fixture(scope="module")
def pair():
    weights = mini_weights()
    jax_model = JaxSylber(hubert_config=jax_hubert.HubertConfig(**_hub()), params=weights, **KW)
    port = Sylber(hubert_config=port_hubert.HubertConfig(**_hub()),
                  params=state_dict_from_jax_params(weights), device="cpu", **KW)
    return jax_model, port, _batch(stage2=True)


def _close(got, want, tol=2e-4):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def test_segment_matches_jax(pair):
    jax_model, port, batch = pair
    wav = batch["input_values"]
    jf, jsegs, jseg_f = jax_model.segment(wav)
    pf, psegs, pseg_f = port.segment(wav)
    _close(pf, jf)
    assert len(psegs) == len(jsegs) == 2 and sum(len(s) for s in jsegs) > 4
    for a, b in zip(psegs, jsegs):
        np.testing.assert_array_equal(a, b)
    _close(pseg_f, jseg_f)
    with pytest.raises(ValueError, match="normthreshold"):
        Sylber(hubert_config=port_hubert.HubertConfig(**_hub()), device="cpu").segment(wav)


def test_forward_and_ema_step_match_jax(pair):
    jax_model, port, batch = pair
    wav, mask = batch["input_values"], batch["attention_mask"]
    want = jax_model.forward(wav, attention_mask=mask)
    got = port.forward(wav, attention_mask=mask)
    np.testing.assert_allclose(float(got["distillation_loss"].detach()),
                               float(want["distillation_loss"]), rtol=1e-5)
    assert int(got["num_segments"]) == int(want["num_segments"])
    np.testing.assert_allclose(float(got["normthreshold"]), float(want["normthreshold"]),
                               rtol=1e-5)
    for a, b in zip(port.thresholder, jax_model.thresholder):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, equal_nan=True)
    got["distillation_loss"].backward()
    assert port.model.feature_projection.projection.weight.grad.abs().max() > 0

    # stage 1: the given segments
    _, segs, _ = jax_model.segment(wav)
    want = jax_model.forward(wav, segments=segs, attention_mask=mask)
    got = port.forward(wav, segments=segs, attention_mask=mask)
    np.testing.assert_allclose(float(got["distillation_loss"].detach()),
                               float(want["distillation_loss"]), rtol=1e-5)

    # the EMA: move the student, then one decay step on both sides
    with torch.no_grad():
        for p in port.model.parameters():
            p.add_(0.01)
    jax_model.params = jax.tree.map(lambda p: p + 0.01, jax_model.params)
    port.ema_step()
    want_ema = jax_ema_update(jax_model.ema_params, jax_model.params, 0.9)
    got_ema = jax_params_from_state_dict(port.teacher.state_dict())
    for path, w in jax.tree_util.tree_leaves_with_path(want_ema):
        node = got_ema
        for k in path:
            node = node[k.key]
        np.testing.assert_allclose(node, np.asarray(w), rtol=1e-6, atol=1e-7)
