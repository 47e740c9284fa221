"""One stage-2 training step of the port against ``sylber_tpu.train.distill``:
the loss, every gradient and the segments found online on the teacher's
states. The setting and the tolerances are those of
``test_torch_distill.py``; three steps with and without
``use_train_thrupdate`` are in ``test_torch_distill_stage2_steps.py``, so
that each file stays short."""

from test_torch_distill import check_gradients  # noqa: E402 (same-dir test module)
from _torch_threads import _few_threads  # noqa: E402,F401 (autouse)


def test_stage2_gradients_and_segments_match_jax():
    check_gradients(stage2=True)
