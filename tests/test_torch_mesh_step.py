"""One distillation step across ranks (``sylber_tpu_torch/parallel/mesh.py``),
stage 1; stage 2 is ``test_torch_mesh_step_stage2.py``, which reuses this
file's machinery.

The ranks are real processes joined over gloo on the CPU (started once per
world size by ``parallel/launch.py``, rendezvous through a ``FileStore``):
two for dp=2, dp=2 with FSDP and mp=2, four for dp=2 x mp=2. Each layout
runs two steps of the tiny encoder of ``tests/multidevice/test_dp_tp.py``
(fp32 "highest", dropout 0) on the same global batch of 4 utterances, and
is held against

- the one-process port step on the global batch, with span masking, noise
  and utterance mixing on and a merge-threshold range (their draws are the
  global batch's, sliced to each rank's rows): loss, grad norm and counts
  rtol 1e-5; the thresholder rtol 1e-5; the online segments exact; every
  parameter and EMA leaf within 1e-5 of its largest magnitude (or of 1),
  each AdamW moment within 1e-4 of the moment's largest magnitude over all
  leaves (in practice the differences are summation order);
- JAX's step on ``make_mesh`` of the same shape (GSPMD over the simulated
  CPU devices), from the same initial weights, with the draws off (span
  masking and noise off, an empty merge-threshold range: nothing in either
  step is random, so the two can be compared): both steps' loss rtol 1e-4,
  the first's grad norm rtol 1e-4 and counts exact, the thresholder and the
  EMA after the second (the EMA takes the first step's parameters) rtol
  1e-5 and within 2e-5 of each leaf's largest magnitude (or of 1); the
  parameters after the first step within 1e-4 (a tenth of the step's lr:
  AdamW's eps of 1e-4 turns a gradient's rounding into lr / eps = 10 times
  as much movement where the clipped gradient is near 0; 2.4e-5 is the
  largest seen), its AdamW moments within 1e-3 of the moment's largest
  magnitude (a gradient differs by summation order, and the second moment
  squares it). Not the parameters after the second: AdamW's
  first update moves every element by about lr times the sign of its
  gradient, and a gradient that is 0 in exact arithmetic (the key bias's)
  takes its sign from rounding, so the second step's gradients of the
  random-weight encoder differ between any two programs (0.6 % in norm
  between the one-device port and JAX steps in stage 2).
  JAX's step on the 2 x 2 mesh of the
  simulated CPU devices is no yardstick: its gradient differs from JAX's
  own one-device step (grad norm 144.37 against 143.18 on this batch, where
  its dp=2, dp=4, mp=2 and mp=4 meshes give 143.18 to 6 digits), so the
  port's dp=2 x mp=2 step is held against JAX's dp=2 mesh instead.

Also: FSDP composed with mp (dp=2 x mp=2, each mp index's pieces sharded
over its dp group) and ``accumulate_grad_batches`` 2 at dp=2 against one
process, and dropout
0.1, under which the two ranks draw different masks (seeded from ``(seed,
step, rank)``) while rank 0 draws the one-process masks. The JAX compiles
run while the ranks work.
"""

import numpy as np
import pytest
import torch

import jax
from sylber_tpu.models import hubert as jax_hubert
from sylber_tpu.parallel import mesh as jax_mesh
from sylber_tpu.train import distill as jax_distill
from sylber_tpu_torch.io.checkpoint import jax_params_from_state_dict
from sylber_tpu_torch.parallel import mesh as port_mesh
from sylber_tpu_torch.parallel.launch import start

import _torch_mesh_workers as W  # noqa: E402 (same-dir helper module)
from _torch_threads import _few_threads  # noqa: E402,F401 (autouse)

LAYOUTS = {"dp2": dict(dp=2, mp=1), "dp2_fsdp": dict(dp=2, mp=1, fsdp=True),
           "mp2": dict(dp=1, mp=2), "dp2xmp2": dict(dp=2, mp=2)}


# FSDP over dp=2 inside each mp index of a 2 x 2 mesh: held against one
# process only (stage 1)
COMPOSED = {"dp2xmp2_fsdp": dict(dp=2, mp=2, fsdp=True)}


def case_id(case):
    layout = next(k for k, v in {**LAYOUTS, **COMPOSED}.items()
                  if all(case.get(f, False) == v.get(f, False) for f in ("dp", "mp", "fsdp")))
    return (f"{layout}-{'draws' if case.get('draws', True) else 'exact'}"
            f"-thr{int(case.get('thrupdate', True))}-acc{case.get('accumulate', 1)}")


def plan(stage2, thrupdates=(True,), extra=(), extra4=()):
    """The cases of each world: port-vs-port with the draws for each
    ``thrupdate``, port-vs-JAX without them, and ``extra`` on 2 ranks
    (``extra4`` on 4)."""
    cases = {2: [], 4: []}
    for name, lay in LAYOUTS.items():
        world = lay["dp"] * lay["mp"]
        for thr in thrupdates:
            cases[world].append(dict(lay, stage2=stage2, thrupdate=thr, draws=True))
        cases[world].append(dict(lay, stage2=stage2, thrupdate=True, draws=False))
    cases[2] += list(extra)
    cases[4] += list(extra4)
    return cases


def close(got, want, rel, what, scale=None):
    """|got - want| within ``rel`` of ``scale`` (default the largest |want|,
    1 if smaller)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if scale is None:
        scale = max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= rel * scale, (what, err, rel * scale)


def moment_scale(moments):
    """The largest magnitude among all leaves of one moment: a leaf whose
    gradient is 0 in exact arithmetic (the key bias) holds rounding noise,
    measured against the moment's scale, not its own."""
    return max(float(np.abs(np.asarray(v)).max()) for v in moments)


def jax_tree(sd):
    return jax_params_from_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()})


def leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


# layouts held against another of JAX's meshes (see the docstring)
JAX_MESH = {"dp2xmp2": "dp2"}


def jax_mesh_run(case, weights, batch):
    """JAX's step, twice, on ``make_mesh(dp, mp)`` (FSDP at min size 1024
    where the case asks), from ``weights`` (a JAX tree)."""
    import jax.numpy as jnp

    hub, fields = W.config_fields(case)
    cfg = jax_distill.DistillConfig(model=jax_hubert.HubertConfig(**hub), **fields)
    state = jax_distill.init_train_state(cfg, jax.random.PRNGKey(0), params=weights,
                                         thresholder_kwargs=W.THR)
    mesh = jax_mesh.make_mesh(dp=case["dp"], mp=case["mp"])
    tp, fsdp = case["mp"] > 1, case.get("fsdp", False)
    rep = lambda t: jax.tree.map(lambda x: jax_mesh.replicated(x, mesh), t)  # noqa: E731
    if fsdp:
        specs = jax_mesh.hubert_param_specs(state.opt_state, use_tp=tp, fsdp_dp=case["dp"],
                                            fsdp_min_size=W.FSDP_MIN_SIZE)
        opt = jax.tree.map(lambda x, s: jax_mesh.put_global(x, mesh, s), state.opt_state, specs)
    else:
        opt = rep(state.opt_state)
    shard = lambda p: jax_mesh.shard_params(p, mesh, use_tp=tp, fsdp=fsdp,  # noqa: E731
                                            fsdp_min_size=W.FSDP_MIN_SIZE)
    state = state._replace(params=shard(state.params), ema_params=shard(state.ema_params),
                           opt_state=opt, step=rep(state.step), thresholder=rep(state.thresholder))
    jb = {k: (jnp.asarray(v.numpy()) if v is not None else None) for k, v in batch.items()}
    step = jax.jit(jax_distill.make_train_step(cfg))
    fetch = lambda t: jax.tree.map(np.asarray, jax_mesh.fetch_global(t))  # noqa: E731
    metrics, first = [], None
    with jax.set_mesh(mesh):
        for i in range(2):
            state, m = step(state, jax_mesh.shard_batch(jb, mesh),
                            jax_mesh.replicated(jax.random.PRNGKey(i), mesh))
            metrics.append({k: float(v) for k, v in m.items()})
            if i == 0:
                adam = [x for x in jax.tree.leaves(state.opt_state,
                                                   is_leaf=lambda x: hasattr(x, "mu"))
                        if hasattr(x, "mu")][0]
                first = dict(params=fetch(state.params), mu=fetch(adam.mu), nu=fetch(adam.nu))
    return dict(metrics=metrics, thresholder=[float(t) for t in state.thresholder],
                ema=fetch(state.ema_params), first=first)


class MeshRuns:
    """The worlds of a stage, started at once; JAX's mesh steps computed
    while they run; the one-process references on demand."""

    def __init__(self, root, stage2, thrupdates=(True,), extra=(), extra4=()):
        self.cases = plan(stage2, thrupdates, extra, extra4)
        self.worlds = {n: start(W.step_world, n, root, cs) for n, cs in self.cases.items()}
        self.stage2 = stage2
        self._one, self._port = {}, None
        self.whole_params = W.run_case(dict(stage2=stage2, steps=0))["params"]
        weights = jax_tree(self.whole_params)
        batch = W.global_batch(stage2)
        exact = [c for cs in self.cases.values() for c in cs if not c.get("draws", True)]
        by_layout = {case_id(c).split("-")[0]: c for c in exact}
        runs = {name: jax_mesh_run(c, weights, batch) for name, c in by_layout.items()
                if name not in JAX_MESH}
        self.jax = {case_id(c): runs[JAX_MESH.get(name, name)] for name, c in by_layout.items()}

    @property
    def port(self):
        if self._port is None:
            self._port = {}
            for n, world in self.worlds.items():
                for c, r in zip(self.cases[n], world.results()[0]):
                    self._port[case_id(c) if "probe" not in c else c["probe"]] = r
        return self._port

    def one_process(self, case):
        key = (case.get("thrupdate", True), case.get("draws", True), case.get("accumulate", 1))
        if key not in self._one:
            self._one[key] = W.run_case(dict(stage2=self.stage2, thrupdate=key[0], draws=key[1],
                                             accumulate=key[2]))
        return self._one[key]


def check_against_one_process(got, want, stage2):
    for a, b in zip(got["metrics"], want["metrics"]):
        for k in ("loss", "grad_norm", "num_segments", "masked_frames"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["thresholder"], want["thresholder"], rtol=1e-5,
                               equal_nan=True)
    if stage2:
        assert np.array_equal(got["segments"][1], want["segments"][1])
        assert np.array_equal(got["segments"][0], want["segments"][0])
        assert want["segments"][1].sum() > 4
    for part in ("params", "ema"):
        assert got[part].keys() == want[part].keys()
        for k in want[part]:
            close(got[part][k], want[part][k], 1e-5, f"{part} {k}")
    for m in ("exp_avg", "exp_avg_sq"):
        scale = moment_scale(mom[m] for mom in want["moments"].values())
        for k, mom in want["moments"].items():
            close(got["moments"][k][m], mom[m], 1e-4, f"{m} {k}", scale)


def check_against_jax(got, want, stage2):
    for i, (a, b) in enumerate(zip(got["metrics"], want["metrics"])):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)
        assert a["num_segments"] == b["num_segments"]
        if stage2:
            np.testing.assert_allclose(a["normthreshold"], b["normthreshold"], rtol=1e-5)
        if i == 0:
            np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-4)
    np.testing.assert_allclose(got["thresholder"], want["thresholder"], rtol=1e-5,
                               equal_nan=True)
    for part, got_part, want_part, rel in (
            ("ema", got["ema"], want["ema"], 2e-5),
            ("params", got["first"]["params"], want["first"]["params"], 1e-4)):
        want_leaves = dict(leaves(want_part))
        got_leaves = dict(leaves(jax_tree(got_part)))
        assert got_leaves.keys() == want_leaves.keys()
        for k, w in want_leaves.items():
            close(got_leaves[k], w, rel, f"{part} {k}")
    for m, jm in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
        got_m = dict(leaves(jax_tree({k: v[m] for k, v in got["first"]["moments"].items()})))
        want_m = dict(leaves(want["first"][jm]))
        scale = moment_scale(want_m.values())
        assert got_m.keys() == want_m.keys()
        for k, w in want_m.items():
            close(got_m[k], w, 1e-3, f"{m} {k}", scale)


EXTRA = [dict(dp=2, mp=1, stage2=False, accumulate=2, steps=2),
         dict(dp=2, mp=1, stage2=False, probe="dropout")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return MeshRuns(str(tmp_path_factory.mktemp("worlds")), stage2=False, extra=EXTRA,
                    extra4=[dict(COMPOSED["dp2xmp2_fsdp"], stage2=False, draws=True)])


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mesh_step_equals_one_process_step(runs, layout):
    case = dict(LAYOUTS[layout], stage2=False, thrupdate=True, draws=True)
    check_against_one_process(runs.port[case_id(case)], runs.one_process(case), False)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mesh_step_equals_jax_mesh_step(runs, layout):
    case = dict(LAYOUTS[layout], stage2=False, thrupdate=True, draws=False)
    check_against_jax(runs.port[case_id(case)], runs.jax[case_id(case)], False)


def test_fsdp_composes_with_tensor_parallelism(runs):
    case = dict(COMPOSED["dp2xmp2_fsdp"], stage2=False, draws=True)
    check_against_one_process(runs.port[case_id(case)], runs.one_process(case), False)


@pytest.mark.parametrize("layout", ["dp2_fsdp", "dp2xmp2_fsdp"])
def test_fsdp_shards_the_leaves_of_the_plan(runs, layout):
    """FSDP shards the student's and the teacher's leaves that the plan
    (``hubert_param_specs``, held against JAX's in ``test_torch_mesh_plan.py``)
    gives the dp axis, and no other."""
    case = dict({**LAYOUTS, **COMPOSED}[layout], stage2=False, draws=True)
    specs = port_mesh.hubert_param_specs(runs.whole_params, use_tp=case["mp"] > 1,
                                         fsdp_dp=case["dp"], fsdp_min_size=W.FSDP_MIN_SIZE)
    want = sorted(n for n, s in specs.items() if "dp" in s)
    assert 0 < len(want) < len(specs)
    assert runs.port[case_id(case)]["sharded"] == [want, want]


def test_accumulated_steps_under_dp_equal_one_process(runs):
    case = EXTRA[0]
    check_against_one_process(runs.port[case_id(case)], runs.one_process(case), False)


def test_dropout_masks_differ_between_ranks(runs):
    out = runs.port["dropout"]
    assert not np.allclose(out[0], out[1])      # the same input, each rank's masks
    want = W.dropout_masks(None)                 # rank 0 draws the one-process masks
    np.testing.assert_array_equal(out[:1], want)
