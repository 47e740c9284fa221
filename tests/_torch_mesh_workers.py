"""What the ranks of the mesh tests run (``tests/test_torch_mesh*.py``).

The ranks are started by ``sylber_tpu_torch.parallel.launch.spawn``, which
imports this module by name in every rank: it imports torch and the port
only (a test module would cost every rank JAX's import). The same functions
give the one-process references in the test process (``mesh=None``).

The tiny encoder of ``tests/multidevice/test_dp_tp.py`` (64 wide, 4 heads,
2 layers), fp32 "highest", dropout 0 unless a case says otherwise; a global
batch of 4 synthetic utterances of at most 0.5 s.
"""

from __future__ import annotations

import torch

from sylber_tpu_torch.data.dataset import SyntheticSpeechDataset
from sylber_tpu_torch.data.noise import NoiseMixerConfig
from sylber_tpu_torch.models.hubert import HubertConfig
from sylber_tpu_torch.parallel import mesh as port_mesh
from sylber_tpu_torch.parallel.mesh import all_gather_cat, is_dtensor, make_mesh, shard_batch
from sylber_tpu_torch.train import distill

THR = dict(signal_mean=6.10, signal_var=0.87, noise_mean=0.34, noise_var=0.34)
TINY = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
            conv_dim=(16,) * 7, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
            precision="highest")
GLOBAL_B = 4
FSDP_MIN_SIZE = 1024   # of the tiny encoder's leaves, FSDP shards the weights


def config_fields(case: dict):
    """``(HubertConfig fields, DistillConfig fields)`` of a case, the same
    for the port and JAX. ``draws`` (default on): span masking, noise and
    utterance mixing, a merge-threshold range; off, nothing in a step is
    random (the setting in which the port is held against JAX)."""
    rate = case.get("dropout", 0.0)
    hub = dict(TINY, hidden_dropout=rate, attention_dropout=rate, activation_dropout=rate,
               feat_proj_dropout=0.0)
    draws = case.get("draws", True)
    fields = dict(segment_online=case["stage2"], use_train_thrupdate=case.get("thrupdate", True),
                  merge_threshold_range=(0.8, 0.9) if draws else (0.8, 0.8),
                  thresholder_decay=0.99, ema_decay=0.99, lr=1e-3, warmup_steps=0,
                  total_steps=100, mask_prob=0.5 if draws else 0.0,
                  min_mask_n=1 if draws else 0, max_mask_set=2, do_noise_augment=draws,
                  accumulate_grad_batches=case.get("accumulate", 1))
    return hub, fields


def distill_config(case: dict) -> distill.DistillConfig:
    hub, fields = config_fields(case)
    return distill.DistillConfig(
        model=HubertConfig(**hub),
        noise_mixer=NoiseMixerConfig(augment_prob=1.0, utterance_mix_ratio=0.5), **fields)


def global_batch(stage2: bool):
    ds = SyntheticSpeechDataset(n_utts=GLOBAL_B, max_len=8000, with_segments=not stage2,
                                seed=3, utt_seconds=(0.3, 0.6))
    b = ds.collate([ds[i] for i in range(GLOBAL_B)])
    return {k: (torch.from_numpy(v) if v is not None else None) for k, v in b.items()}


def _segments(state, batch, cfg, mesh):
    """The step's online segments of the global batch (before the step)."""
    wav, mask, target = distill.teacher_targets(state.teacher, batch)
    gens = distill.step_generators(0, state.step, "cpu")
    segs, nseg, _, _ = distill.online_segments(target, mask, state.thresholder, gens, cfg, mesh)
    if mesh is not None:
        segs = all_gather_cat(segs, 0, mesh.group("dp"))
        nseg = all_gather_cat(nseg, 0, mesh.group("dp"))
    return segs.numpy(), nseg.numpy()


def _whole(state):
    """Copies of the whole parameters, EMA and AdamW moments (gathered under
    a mesh; without one the state dicts hold the live tensors)."""
    full = state.state_dict()
    names = [n for n, _ in state.student.named_parameters()]
    moments = {names[i]: {k: v.numpy().copy() for k, v in st.items() if k != "step"}
               for i, st in full["optimizer"]["state"].items()}
    as_np = lambda sd: {k: v.numpy().copy() for k, v in sd.items()}  # noqa: E731
    return dict(params=as_np(full["params"]), ema=as_np(full["ema"]), moments=moments)


def run_case(case: dict, mesh=None):
    """``case["steps"]`` steps on the global batch (this rank's rows under
    ``mesh``): the metrics of each, the online segments of the first, the
    thresholder, and the whole parameters, EMA and AdamW moments after (and
    after the first step too, as ``first``, where the draws are off); the
    names of the student's and the teacher's leaves that FSDP shards."""
    cfg = distill_config(case)
    state = distill.init_train_state(cfg, "cpu", thresholder_kwargs=THR, seed=0, mesh=mesh,
                                     fsdp=case.get("fsdp", False), fsdp_min_size=FSDP_MIN_SIZE)
    sharded = [sorted(n for n, p in m.named_parameters() if is_dtensor(p))
               for m in (state.student, state.teacher)]
    batch = shard_batch(global_batch(case["stage2"]), mesh)
    step = distill.make_train_step(cfg, mesh)
    metrics, segments, first = [], None, None
    for i in range(case.get("steps", 2)):
        if case["stage2"] and i == 0:
            segments = _segments(state, batch, cfg, mesh)
        m = step(state, batch, 0)
        metrics.append({k: float(v) for k, v in m.items() if torch.is_tensor(v)})
        if i == 0 and not case.get("draws", True):
            first = _whole(state)
    return dict(metrics=metrics, segments=segments, first=first, sharded=sharded,
                thresholder=[float(t) for t in state.thresholder], **_whole(state))


def dropout_masks(mesh):
    """The student's train-mode output on the same input on every rank, with
    the step's dropout generator of the rank: gathered over dp."""
    cfg = distill_config({"stage2": False, "dropout": 0.1})
    state = distill.init_train_state(cfg, "cpu", thresholder_kwargs=THR, seed=0, mesh=mesh)
    gens = distill.step_generators(0, 0, "cpu", rank=mesh.dp_rank if mesh else 0)
    x = global_batch(False)["input_values"][:1]
    state.student.train()
    with torch.no_grad():
        out = state.student(x, generator=gens.drop)
    return (all_gather_cat(out, 0, mesh.group("dp")) if mesh is not None else out).numpy()


def step_world(rank: int, world: int, cases):
    """Each case on a mesh of its ``dp x mp`` over this world (all ranks
    call; rank 0's results are returned, in order)."""
    out = []
    for case in cases:
        mesh = make_mesh(case["dp"], case["mp"], device_type="cpu")
        if case.get("probe") == "dropout":
            res = dropout_masks(mesh)
        else:
            res = run_case(case, mesh)
        out.append(res if rank == 0 else None)
    return out



# ---- the training loop (test_torch_mesh_loop.py) ---------------------------

LOOP_CFG = {
    "name": "mesh_loop", "seed": 0,
    "model": {"encoding_layer": 1,
              "hubert": {"hidden_size": 32, "num_attention_heads": 4, "intermediate_size": 64,
                         "conv_dim": [16] * 7, "num_conv_pos_embeddings": 16,
                         "num_conv_pos_embedding_groups": 4,
                         "hidden_dropout": 0.0, "attention_dropout": 0.0,
                         "activation_dropout": 0.0},
              "precision": "highest", "lr": 0.001, "warmup_steps": 2, "total_steps": 50},
    "data": {"synthetic": True, "n_utts": 16, "max_len": 16000, "batch_size": 8},
}


def _train_quiet(cfg, out_dir, max_steps, ckpt_every=2):
    """``train()`` on the CPU, its printed lines returned."""
    import contextlib
    import io

    from sylber_tpu_torch.train.loop import train

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train(cfg, out_dir=out_dir, max_steps=max_steps, log_every=1, ckpt_every=ckpt_every,
              device="cpu")
    return buf.getvalue()


def loop_world(rank: int, world: int, root: str):
    """The loop on 2 ranks whose process group the first run's
    ``distributed:`` block forms (a ``file://`` rendezvous): dp=2 for 4
    steps, then resumed to 6; the same with FSDP; dp=2 with
    ``steps_per_dispatch: 2`` for 2 steps (one step a dispatch under a
    process group); then the refusals."""
    import os

    import torch.distributed as dist

    port_mesh.PROCESS_GROUP_TIMEOUT_S = 120.0   # a test's rank waits less for a lost peer
    block = {"coordinator_address": f"file://{os.path.join(root, 'rendezvous')}",
             "num_processes": world, "process_id": rank}
    out = {}
    for name, mesh in (("dp", {"dp": 2}),
                       ("fsdp", {"dp": 2, "fsdp": True, "fsdp_min_size": FSDP_MIN_SIZE})):
        cfg = dict(LOOP_CFG, mesh=mesh, distributed=block)
        run_dir = os.path.join(root, name)
        out[name] = [_train_quiet(cfg, run_dir, 4), _train_quiet(cfg, run_dir, 6)]
        out["group_formed_by_block"] = dist.is_initialized() and dist.get_world_size() == world
    cfg = dict(LOOP_CFG, mesh={"dp": 2}, distributed=block, steps_per_dispatch=2)
    out["spd"] = _train_quiet(cfg, os.path.join(root, "spd"), 2, ckpt_every=0)
    errors = []
    for bad in (dict(LOOP_CFG, mesh={"dp": 4}),
                dict(LOOP_CFG, mesh={"dp": 2}, data=dict(LOOP_CFG["data"], batch_size=3))):
        try:
            _train_quiet(bad, os.path.join(root, "bad"), 1)
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors
    return out


# ---- the resynthesis trainers (test_torch_mesh_trainers.py) ----------------

def vq_steps(mesh, fixtures: str, steps: int = 3):
    """``steps`` joint-VQ steps from the mini fixtures (input dropout 0) on a
    seeded global batch of 4 x 24 frames with blank frames, the EMA counts
    set just above the dead threshold first, so that the codes the batch
    misses die and are reseeded: the losses, and the codebooks, EMA counts
    and sums after (this rank's, which are everyone's)."""
    import dataclasses
    import os

    import numpy as np

    from sylber_tpu_torch import synthesis as tsyn
    from sylber_tpu_torch.flow.quantizer import QuantizerState, VQState
    from sylber_tpu_torch.io.checkpoint import load_params_npz
    from sylber_tpu_torch.train import vq_synthesis as tvq
    from sylber_tpu_torch.vq_tokenizer import TrainedVQTokenizer
    import json

    meta = json.loads(open(os.path.join(fixtures, "mini_vq_synth.json")).read())
    mc = meta["config"]["model"]
    pc = dataclasses.replace(tsyn.synthesis_config_from_dict(mc), input_dropout=0.0)
    qcfg = tvq.quantizer_config_from_dict(mc["quantizer_configs"], input_dim=144)
    tok = TrainedVQTokenizer.load_npz(os.path.join(fixtures, "mini_vq_tokenizer.npz"), qcfg,
                                      device="cpu")
    params = {"hubert": load_params_npz(os.path.join(fixtures, "mini_ckpt.npz")),
              **load_params_npz(os.path.join(fixtures, "mini_vq_synth.npz"))}
    synth = tsyn.SegmentSynthesis(config=pc, params=params, device="cpu")
    q = tok.state
    near_dead = lambda v, c: VQState(v.codebooks, torch.full_like(  # noqa: E731
        v.cluster_sizes, c.dead_threshold * 1.001), v.embed_avgs)
    q = QuantizerState(q.encoder, near_dead(q.art_vq, qcfg.art_vq),
                       near_dead(q.pitch_vq, qcfg.pitch_vq))
    opt = tsyn.make_synthesis_optimizer(lr=4e-4, warmup_steps=0, total_steps=100,
                                        min_factor=0.05)
    state = tvq.init_vq_synthesis_train_state(synth, qcfg, opt, quantizer=q)
    step = tvq.make_vq_synthesis_train_step(synth, qcfg, opt, pitch_weight=1.0, mesh=mesh)
    rng = np.random.RandomState(7)
    feats = rng.randn(4, 24, 144).astype(np.float32)
    feats[:, 18:] = 0.0                       # blank frames
    feats[3, 6:] = 0.0
    art = rng.rand(4, 24, 14).astype(np.float32) * 0.1
    batch = {"features": torch.from_numpy(feats), "art": torch.from_numpy(art)}
    local = shard_batch(batch, mesh)
    metrics = []
    for _ in range(steps):
        m = step(state, local, 0)
        metrics.append({k: float(v) for k, v in m.items()})
    vq = state.quantizer
    return dict(metrics=metrics, **{f"{name}_{f}": getattr(getattr(vq, name), f).numpy().copy()
                                    for name in ("art_vq", "pitch_vq")
                                    for f in ("codebooks", "cluster_sizes", "embed_avgs")})


def vocoder_step(mesh):
    """One vocoder GAN step (JAX's ``test_trainer_meshes.py`` shapes: 14 in,
    8 cond channels, 32 wide, B8 x 16 frames) on this rank's rows: the
    losses and the generator's parameters after."""
    import numpy as np

    from sylber_tpu_torch.vocoder.hifigan import (HiFiGANConfig, VocoderTrainConfig,
                                                  make_vocoder_train_step)

    g = HiFiGANConfig(in_channels=14, cond_channels=8, upsample_initial_channel=32)
    init_fn, step_fn = make_vocoder_train_step(VocoderTrainConfig(model=g), precision="highest",
                                               mesh=mesh)
    state = init_fn("cpu", seed=0)
    rng = np.random.RandomState(0)
    B, T = 8, 16
    feats = torch.from_numpy(rng.randn(B, T, 14).astype(np.float32))
    wav = torch.from_numpy(rng.randn(B, T * g.total_upsample).astype(np.float32) * 0.1)
    cond = torch.zeros(B, 8)
    m = step_fn(state, *shard_batch((feats, wav, cond), mesh))
    return dict(metrics={k: float(v) for k, v in m.items()},
                gen={k: v.detach().numpy().copy()
                     for k, v in state.generator.state_dict().items()})


def trainer_world(rank: int, world: int, root: str, fixtures: str, cfm_cfg: dict):
    """The CFM loop at dp=2 (rank 0 writes into ``root/cfm``), 3 joint-VQ
    steps and one vocoder step on dp=2 meshes."""
    import os

    from sylber_tpu_torch.train.synthesis_loop import train_synthesis

    import contextlib
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        train_synthesis(cfm_cfg, out_dir=os.path.join(root, "cfm"), max_steps=4, log_every=1,
                        eval_steps=2, device="cpu")
    mesh = make_mesh(2, 1, device_type="cpu")
    return dict(vq=vq_steps(mesh, fixtures), vocoder=vocoder_step(mesh))
