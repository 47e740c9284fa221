"""Three stage-2 training steps of the port against
``sylber_tpu.train.distill.make_train_step``, with and without
``use_train_thrupdate``: the first step's metrics and thresholder (updated
in the step), the parameters after the third. The setting and the
tolerances are those of ``test_torch_distill.py``."""

import pytest

from test_torch_distill import check_steps  # noqa: E402 (same-dir test module)
from _torch_threads import _few_threads  # noqa: E402,F401 (autouse)


@pytest.mark.parametrize("thrupdate", [True, False], ids=["thrupdate", "no_thrupdate"])
def test_stage2_train_steps_match_jax(thrupdate):
    check_steps(stage2=True, thrupdate=thrupdate)
