"""One stage-2 distillation step across ranks: online segmentation of the
teacher's states with the thresholder all-reduced over ``dp``, with
``use_train_thrupdate`` both ways. The layouts, references and tolerances
are ``test_torch_mesh_step.py``'s (JAX's mesh step with
``use_train_thrupdate`` on); the segments of the global batch must be the
one-process step's exactly, and the thresholder within rtol 1e-5."""

import pytest

from test_torch_mesh_step import (LAYOUTS, MeshRuns, case_id, check_against_jax,  # noqa: E402
                                  check_against_one_process)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return MeshRuns(str(tmp_path_factory.mktemp("worlds")), stage2=True,
                    thrupdates=(True, False))


@pytest.mark.parametrize("thrupdate", [True, False], ids=["thrupdate", "no_thrupdate"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_stage2_mesh_step_equals_one_process_step(runs, layout, thrupdate):
    case = dict(LAYOUTS[layout], stage2=True, thrupdate=thrupdate, draws=True)
    check_against_one_process(runs.port[case_id(case)], runs.one_process(case), True)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_stage2_mesh_step_equals_jax_mesh_step(runs, layout):
    case = dict(LAYOUTS[layout], stage2=True, thrupdate=True, draws=False)
    check_against_jax(runs.port[case_id(case)], runs.jax[case_id(case)], True)
