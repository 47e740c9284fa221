"""Weight bridge to and from the JAX package's parameter trees, and the
trainer's checkpoints.

``load_params_npz`` reads the single-file ``.npz`` format of
``sylber_tpu.io.checkpoint.save_params_npz`` (keys are '/'-joined tree
paths); ``state_dict_from_jax_params`` turns such a tree into the state dict
of :class:`sylber_tpu_torch.models.hubert.HubertModel`, and
``jax_params_from_state_dict`` / ``save_params_npz`` go the other way, so a
model the port trains loads into either package's ``Segmenter``. The same
carry, :func:`state_dict_from_tree` / :func:`tree_from_state_dict`, serves
the resynthesis modules, whose parameter names are the JAX tree's
(``synthesis_state_dict_from_jax``, ``generator_state_dict_from_jax``,
``discriminator_state_dicts_from_jax``).
:func:`save_params` writes a parameter tree as the JAX package's
``save_params`` does (an Orbax directory, ``io/orbax.py::write_tree``);
:class:`TrainCheckpointManager` keeps the trainer's rolling step
directories in the JAX trainer's Orbax layout (:func:`train_state_to_jax`),
written asynchronously, and resumes from those, from the JAX trainer's
steps and from the port's earlier ``torch.save`` steps (``io/orbax.py``
reads and writes without JAX).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch


def load_params_npz(path: str, dtype=np.float32) -> Dict[str, Any]:
    """Nested dict of numpy arrays; floating leaves cast to ``dtype``
    (checked-in fixtures store float16)."""
    out: Dict[str, Any] = {}
    with np.load(path) as z:
        for key in z.files:
            parts = key.split("/")
            node = out
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            a = z[key]
            if np.issubdtype(a.dtype, np.floating):
                a = a.astype(dtype)
            node[parts[-1]] = a
    return out


# JAX tree node name -> port module path (HuBERT)
_RENAMES = ((re.compile(r"^feature_extractor\.conv_(\d+)\."), r"feature_extractor.convs.\1."),
            (re.compile(r"^layer_(\d+)\."), r"layers.\1."))
_INVERSE_RENAMES = ((re.compile(r"^feature_extractor\.convs\.(\d+)\."),
                     r"feature_extractor.conv_\1."),
                    (re.compile(r"^layers\.(\d+)\."), r"layer_\1."))
# the vocoder generator's transposed convs (flax ``ConvTranspose``)
_GENERATOR_TRANSPOSED = re.compile(r"^ups_\d+\.")


def _leaf(name: str, a: np.ndarray, transposed: bool = False):
    """flax leaf -> (torch leaf name, array in torch layout)."""
    if name == "kernel":
        if a.ndim == 2:    # Dense (in, out) -> Linear (out, in)
            a = a.T
        elif transposed:   # ConvTranspose (k, in, out), kernel not flipped ->
            # conv_transpose1d (in, out, k), which flips it
            a = np.transpose(a[::-1], (1, 2, 0))
        elif a.ndim == 3:  # Conv (k, in/groups, out) -> (out, in/groups, k)
            a = np.transpose(a, (2, 1, 0))
        elif a.ndim == 4:  # 2-D Conv (kh, kw, in, out) -> (out, in, kh, kw)
            a = np.transpose(a, (3, 2, 0, 1))
        return "weight", a
    if name == "scale":    # LayerNorm / GroupNorm
        return "weight", a
    return name, a


def state_dict_from_tree(tree: Mapping[str, Any], renames=(),
                         transposed=None) -> Dict[str, torch.Tensor]:
    """A port module's float32 state dict from a flax parameter tree whose
    node names are the module's (after ``renames``). ``transposed`` matches
    the keys of transposed convs."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for name, value in node.items():
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{name}.")
                continue
            is_t = transposed is not None and bool(transposed.match(prefix))
            leaf, a = _leaf(name, np.asarray(value), is_t)
            key = f"{prefix}{leaf}"
            for pattern, repl in renames:
                key = pattern.sub(repl, key)
            sd[key] = torch.from_numpy(np.array(a, dtype=np.float32))

    walk(tree, "")
    return sd


def tree_from_state_dict(sd: Mapping[str, torch.Tensor], renames=(),
                         transposed=None, as_tensors: bool = False) -> Dict[str, Any]:
    """The flax tree (nested dicts of float32 numpy arrays) of a port state
    dict: the inverse of :func:`state_dict_from_tree`. ``as_tensors``: the
    leaves stay tensors, in their dtype and on their device (views in the
    flax layout where one is transposed)."""
    tree: Dict[str, Any] = {}
    for key, t in sd.items():
        t = t.detach()
        for pattern, repl in renames:
            key = pattern.sub(repl, key)
        *path, leaf = key.split(".")
        if leaf == "weight":
            if t.ndim == 2:      # Linear (out, in) -> Dense (in, out)
                leaf, t = "kernel", t.T
            elif transposed is not None and transposed.match(".".join(path) + "."):
                leaf, t = "kernel", t.permute(2, 0, 1).flip(0)
            elif t.ndim == 3:    # Conv1d (out, in/groups, k) -> (k, in/groups, out)
                leaf, t = "kernel", t.permute(2, 1, 0)
            elif t.ndim == 4:    # Conv2d (out, in, kh, kw) -> (kh, kw, in, out)
                leaf, t = "kernel", t.permute(2, 3, 1, 0)
            else:                # LayerNorm / GroupNorm
                leaf = "scale"
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = t if as_tensors else np.ascontiguousarray(t.float().cpu().numpy())
    return tree


def state_dict_from_jax_params(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's HubertModel state dict from the JAX ``HubertModel`` tree."""
    return state_dict_from_tree(tree, _RENAMES)


def jax_params_from_state_dict(sd: Mapping[str, torch.Tensor],
                               as_tensors: bool = False) -> Dict[str, Any]:
    """The JAX ``HubertModel`` tree (nested dicts of float32 numpy arrays,
    flax layouts; tensors with ``as_tensors``) from the port's state dict:
    the inverse of :func:`state_dict_from_jax_params`."""
    return tree_from_state_dict(sd, _INVERSE_RENAMES, as_tensors=as_tensors)


def synthesis_state_dict_from_jax(tree: Mapping[str, Any]) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{"input_mlp": sd, "regressor": sd}`` for the port's ``InputMLP`` and
    ``Regressor`` from a JAX synthesis tree holding those two subtrees (the
    layout of ``tests/fixtures/mini_synth.npz``), and ``"hubert"`` for the
    encoder where the tree holds one (a ``SynthesisParams`` tree)."""
    sds = {name: state_dict_from_tree(tree[name]) for name in ("input_mlp", "regressor")}
    if "hubert" in tree:
        sds["hubert"] = state_dict_from_jax_params(tree["hubert"])
    return sds


def generator_state_dict_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's HiFi-GAN ``Generator`` state dict from the JAX generator
    tree (``tests/fixtures/mini_vocoder.npz``)."""
    return state_dict_from_tree(tree, transposed=_GENERATOR_TRANSPOSED)


def jax_tree_from_generator(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse of :func:`generator_state_dict_from_jax`."""
    return tree_from_state_dict(sd, transposed=_GENERATOR_TRANSPOSED)


def discriminator_state_dicts_from_jax(tree: Mapping[str, Any]) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{"mpd": sd, "msd": sd}`` for the port's multi-period and
    multi-scale discriminators from the JAX vocoder state's ``disc`` tree
    (``{"mpd": ..., "msd": ...}``)."""
    return {name: state_dict_from_tree(tree[name]) for name in ("mpd", "msd")}


def jax_tree_from_discriminators(sds: Mapping[str, Mapping[str, torch.Tensor]]) -> Dict[str, Any]:
    """Inverse of :func:`discriminator_state_dicts_from_jax`."""
    return {name: tree_from_state_dict(sds[name]) for name in ("mpd", "msd")}


def save_tree_npz(path: str, tree: Mapping[str, Any], dtype=np.float32) -> None:
    """A flax-layout tree as a ``.npz`` of ``dtype`` arrays (keys '/'-joined
    tree paths), which ``sylber_tpu.io.checkpoint.load_params_npz`` and
    :func:`load_params_npz` read."""
    flat: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        for k, v in node.items():
            key = f"{prefix}/{k}" if prefix else k
            if isinstance(v, Mapping):
                walk(v, key)
            else:
                flat[key] = np.asarray(v, dtype)

    walk(tree, "")
    np.savez(path, **flat)  # float weights hardly compress; zlib would take seconds


def save_params_npz(path: str, sd: Mapping[str, torch.Tensor]) -> None:
    """The port's HubertModel state dict as a JAX-layout float32 ``.npz``."""
    save_tree_npz(path, jax_params_from_state_dict(sd))


def load_state_dict(path: str, num_layers: int) -> Dict[str, torch.Tensor]:
    """A HubertModel state dict from a JAX-layout ``.npz``, an Orbax
    directory of the JAX package (``save_params``' layout: the JAX trainer's
    ``params_final``, read by ``io/orbax.py`` without JAX) or a PyTorch HF /
    ``sylber.ckpt`` state dict file (layers past ``num_layers`` dropped)."""
    p = Path(path)
    if p.is_dir():
        from .orbax import load_params

        return state_dict_from_jax_params(load_params(p))
    if not p.exists():
        raise FileNotFoundError(f"checkpoint {path!r} not found")
    if p.suffix == ".npz":
        return state_dict_from_jax_params(load_params_npz(str(p)))
    from .torch_convert import load_torch_checkpoint

    return load_torch_checkpoint(str(p), num_hidden_layers=num_layers)


def _find(tree: Any, keys) -> Optional[Mapping[str, Any]]:
    """The first dict in ``tree`` (depth first) holding every key of ``keys``."""
    if isinstance(tree, Mapping):
        if all(k in tree for k in keys):
            return tree
        children = tree.values()
    elif isinstance(tree, list):
        children = tree
    else:
        return None
    for child in children:
        found = _find(child, keys)
        if found is not None:
            return found
    return None


_THRESHOLDER = ("signal_mean", "signal_var", "noise_mean", "noise_var", "fixed")


def train_state_from_jax(tree: Mapping[str, Any], param_names) -> Dict[str, Any]:
    """The dict :meth:`sylber_tpu_torch.train.distill.TrainState.load_state_dict`
    takes, from a train state the JAX trainer saved (``read_tree`` of
    ``<ckpts>/<step>/default``: ``step``, ``params``, ``ema_params``,
    ``opt_state``, ``thresholder``).

    ``params`` and ``ema_params`` go through :func:`state_dict_from_jax_params`.
    optax's ``ScaleByAdamState`` (``count``, ``mu``, ``nu``; found wherever
    the chain, or ``MultiSteps``' inner state, holds it) becomes torch
    AdamW's per-parameter ``step``, ``exp_avg`` and ``exp_avg_sq`` in the
    torch layout, keyed by the position of each name in ``param_names`` (the
    student's ``named_parameters()`` order), one group whose other settings
    are the live optimizer's (the JAX state holds no rate or decay).
    ``MultiSteps``' ``acc_grads`` become the accumulators; ``step`` and the
    thresholder's statistics carry over."""
    adam = _find(tree["opt_state"], ("count", "mu", "nu"))
    if adam is None:
        raise ValueError("the JAX train state holds no ScaleByAdamState (count, mu, nu)")
    mu, nu = state_dict_from_jax_params(adam["mu"]), state_dict_from_jax_params(adam["nu"])
    count = torch.tensor(float(np.asarray(adam["count"])), dtype=torch.float32)
    names = list(param_names)
    missing = [n for n in names if n not in mu]
    if missing:
        raise KeyError(f"the JAX optimizer state lacks moments for {missing}")
    state = {i: {"step": count.clone(), "exp_avg": mu[n], "exp_avg_sq": nu[n]}
             for i, n in enumerate(names)}
    multi = _find(tree["opt_state"], ("mini_step", "acc_grads"))
    acc = None
    if multi is not None:
        grads = state_dict_from_jax_params(multi["acc_grads"])
        acc = [grads[n] for n in names]
    thr = tree["thresholder"]
    return dict(step=int(np.asarray(tree["step"])),
                params=state_dict_from_jax_params(tree["params"]),
                ema=state_dict_from_jax_params(tree["ema_params"]),
                optimizer={"state": state, "param_groups": [{"params": list(range(len(names)))}]},
                thresholder=tuple(torch.tensor(np.asarray(thr[k], np.float32))
                                  for k in _THRESHOLDER),
                acc_grads=acc)


def save_params(path: str, tree: Mapping[str, Any]) -> None:
    """Write the parameter tree ``tree`` (flax layout: numpy arrays or CPU
    tensors) as the Orbax directory ``path/params``, as
    ``sylber_tpu.io.checkpoint.save_params`` does: through a temporary
    directory that replaces any earlier ``params`` when complete."""
    from .orbax import STANDARD_HANDLER, write_checkpoint_metadata, write_tree

    root = Path(path)
    root.mkdir(parents=True, exist_ok=True)
    t0 = time.time_ns()
    tmp = root / f".params.{os.urandom(4).hex()}.tmp"
    try:
        write_tree(tmp, tree)
        write_checkpoint_metadata(tmp, STANDARD_HANDLER, t0)
        shutil.rmtree(root / "params", ignore_errors=True)
        os.replace(tmp, root / "params")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def train_state_to_jax(state: Mapping[str, Any], param_names, cfg) -> Dict[str, Any]:
    """The JAX trainer's train state (``sylber_tpu/train/distill.py``'s
    ``TrainState``: ``step``, ``params``, ``ema_params``, ``opt_state``,
    ``thresholder``, NamedTuples as dicts of their fields) from the port's
    :meth:`TrainState.state_dict` layout: the inverse of
    :func:`train_state_from_jax`. The leaves stay tensors where they are
    (views in the flax layout), so that a caller copies them off the card
    once.

    ``opt_state`` is optax's ``chain(clip_by_global_norm, adamw)`` state,
    ``(EmptyState, (ScaleByAdamState(count, mu, nu), EmptyState,
    ScaleByScheduleState(count)))`` (an ``EmptyState`` is ``None``), wrapped
    in ``MultiStepsState(mini_step, gradient_step, inner_opt_state,
    acc_grads, skip_state=())`` when ``cfg.accumulate_grad_batches > 1``.
    ``mu`` and ``nu`` are AdamW's ``exp_avg`` and ``exp_avg_sq`` by the
    position of each name in ``param_names``; before AdamW's first update
    they and the counts are zeros, as optax's ``init`` gives. Counts and
    steps are int32, as in JAX."""
    names = list(param_names)
    params = state["params"]
    opt = state["optimizer"]["state"]
    jax = lambda sd: jax_params_from_state_dict(sd, as_tensors=True)  # noqa: E731
    first = opt.get(0)
    if first is not None:
        count = first["step"].detach().to(torch.int32).reshape(())
    else:
        count = torch.zeros((), dtype=torch.int32)
    moment = lambda key: {n: (opt[i][key] if i in opt else torch.zeros_like(params[n]))  # noqa: E731
                          for i, n in enumerate(names)}
    inner = [None, [{"count": count, "mu": jax(moment("exp_avg")),
                     "nu": jax(moment("exp_avg_sq"))}, None, {"count": count}]]
    k = int(cfg.accumulate_grad_batches)
    step = int(state["step"])
    if k > 1:
        acc = state["acc_grads"]
        opt_state = {"mini_step": np.int32(step % k), "gradient_step": np.int32(step // k),
                     "inner_opt_state": inner,
                     "acc_grads": jax({n: a for n, a in zip(names, acc)}), "skip_state": ()}
    else:
        opt_state = inner
    thr = dict(zip(_THRESHOLDER, state["thresholder"]))
    return {"step": np.int32(step), "params": jax(params), "ema_params": jax(state["ema"]),
            "opt_state": opt_state, "thresholder": thr}


PORT_MARKER = "port.json"  # beside ``default/``: a step the port wrote, and what JAX's lacks


def _leaves_with_names(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_names(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_names(v, f"{prefix}{i}.")
    elif isinstance(tree, torch.Tensor):
        yield prefix[:-1], tree


def _replace_leaves(tree, new: Mapping[str, Any], prefix=""):
    if isinstance(tree, dict):
        return {k: _replace_leaves(v, new, f"{prefix}{k}.") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_replace_leaves(v, new, f"{prefix}{i}.") for i, v in enumerate(tree)]
        return type(tree)(out)
    return new.get(prefix[:-1], tree)


def _host_buffers(layout, pinned: bool) -> Dict[str, torch.Tensor]:
    """Host tensors of ``layout`` (``(name, shape, dtype)`` each) as views of
    one buffer, each 64-byte aligned: one allocation (one page-locking where
    ``pinned``), not one a leaf."""
    offsets, total = [], 0
    for _, shape, dtype in layout:
        offsets.append(total)
        total += -(-torch.Size(shape).numel() * dtype.itemsize // 64) * 64
    arena = torch.empty(max(total, 1), dtype=torch.uint8, pin_memory=pinned)
    return {name: arena[off:off + torch.Size(shape).numel() * dtype.itemsize].view(dtype)
            .view(shape) for (name, shape, dtype), off in zip(layout, offsets)}


class TrainCheckpointManager:
    """Rolling train-state checkpoints in the JAX package's Orbax layout,
    saved asynchronously, with resume.

    :meth:`save` writes ``<directory>/<step>/default`` (the Orbax item that
    the JAX package's ``TrainCheckpointManager`` restores: ``tree``, usually
    :func:`train_state_to_jax` of the port's state),
    ``<step>/_CHECKPOINT_METADATA`` and ``<step>/port.json`` (``marker``:
    what the port's resume needs and the JAX tree lacks; it also marks a step
    the port wrote). The tree's tensors are copied off the card once, on
    the current stream (so ahead of the next step's in-place updates of
    AdamW and the EMA), into views of one host buffer (pinned for a card's
    tensors) that is made at the first save and reused while the tree's
    layout stays; then one background thread writes the step
    through a temporary directory that is renamed when complete, so a run
    killed during a write leaves no step that ``latest_step`` would pick up.
    At most one write is in flight: a save first waits for the one before.
    A write's exception is raised by the next :meth:`save`, :meth:`wait` or
    :meth:`close`; nothing falls back to another format. The ``max_to_keep``
    newest steps the port wrote are kept. :attr:`records` holds each save's
    times and bytes.

    The directory may also hold steps the JAX trainer wrote (``default``
    without ``port.json``) and the port's earlier ``<step>/state.pt``
    (``torch.save``): :meth:`restore` reads all three, without JAX
    (:func:`train_state_from_jax` for an Orbax step), and the newest step
    wins. Pruning leaves the JAX trainer's steps alone, and a save never
    overwrites one. A run resumed from a JAX step continues its parameters,
    EMA, AdamW moments, step count and thresholder; the batches after the
    resume are the port's, drawn from ``(seed, step)`` (``train/loop.py``;
    intended differences (n) and (o) in ``ROADMAP.md`` section 3), not the
    JAX loop's.
    """

    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = Path(directory)
        self.max_to_keep = max_to_keep
        self.directory.mkdir(parents=True, exist_ok=True)
        self.records = []
        self._host: Dict[str, torch.Tensor] = {}
        self._layout = None
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _steps(self, marker: str):
        return sorted(int(d.name) for d in self.directory.iterdir()
                      if d.name.isdigit() and (d / marker).exists())

    def steps(self):
        """Every step saved, by either trainer."""
        return sorted(set(self._steps("state.pt")) | set(self._steps("default/_METADATA")))

    def _port_steps(self):
        return sorted(set(self._steps("state.pt")) | set(self._steps(PORT_MARKER)))

    @property
    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: Mapping[str, Any],
             marker: Optional[Mapping[str, Any]] = None) -> None:
        """Copy ``tree``'s tensors to the host and write step ``step`` on the
        background thread."""
        t_call = time.perf_counter()
        self.wait()
        final = self.directory / str(step)
        if (final / "default").exists() and not (final / PORT_MARKER).exists():
            raise FileExistsError(f"{final} holds a JAX trainer's step; not overwritten")
        leaves = dict(_leaves_with_names(tree))
        cuda = [t for t in leaves.values() if t.is_cuda]
        record = dict(step=step, leaves=len(leaves), pin_ms=0.0)
        layout = [(n, tuple(t.shape), t.dtype) for n, t in leaves.items()]
        if layout != self._layout:  # one host arena for every leaf, made once a layout
            t0 = time.perf_counter()
            self._host = _host_buffers(layout, pinned=bool(cuda))
            self._layout = layout
            record["pin_ms"] = 1e3 * (time.perf_counter() - t0)
        events = stream = None
        if cuda:
            stream = torch.cuda.current_stream(cuda[0].device)
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            events[0].record(stream)
        t0 = time.perf_counter()
        for name, t in leaves.items():
            self._host[name].copy_(t, non_blocking=True)
        if events:
            events[1].record(stream)
        record["bytes"] = sum(b.nbytes for b in self._host.values())
        if not cuda:
            record["host_copy_ms"] = 1e3 * (time.perf_counter() - t0)
        record["save_call_ms"] = 1e3 * (time.perf_counter() - t_call)
        self.records.append(record)
        self._thread = threading.Thread(
            target=self._write, name=f"checkpoint-{step}",
            args=(step, _replace_leaves(tree, self._host), dict(marker or {}), events, record))
        self._thread.start()

    def _write(self, step, tree, marker, events, record) -> None:
        from .orbax import STANDARD_HANDLER, write_checkpoint_metadata, write_tree

        tmp = self.directory / f".{step}.tmp"
        try:
            if events:
                events[1].synchronize()
                record["host_copy_ms"] = events[0].elapsed_time(events[1])
            t0, init_ns = time.perf_counter(), time.time_ns()
            shutil.rmtree(tmp, ignore_errors=True)
            tmp.mkdir()
            stats = write_tree(tmp / "default", tree)
            write_checkpoint_metadata(tmp, {"default": STANDARD_HANDLER}, init_ns)
            (tmp / PORT_MARKER).write_text(json.dumps(dict(marker, step=step)))
            final = self.directory / str(step)
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
            for old in self._port_steps()[:-self.max_to_keep]:
                shutil.rmtree(self.directory / str(old), ignore_errors=True)
            record.update(write_s=time.perf_counter() - t0, disk_bytes=stats["data_file_bytes"])
            record["mb_per_s"] = record["bytes"] / 1e6 / max(record["write_s"], 1e-9)
        except Exception as e:  # raised by the next save, wait or close
            shutil.rmtree(tmp, ignore_errors=True)
            self._error = e

    def wait(self) -> None:
        """Block until the write in flight has ended; raise its exception."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError(f"writing a checkpoint under {self.directory} failed") from e

    def close(self) -> None:
        """:meth:`wait`, then free the host buffers."""
        try:
            self.wait()
        finally:
            self._host, self._layout = {}, None

    def restore(self, step: Optional[int] = None, param_names=None) -> Dict[str, Any]:
        """The saved dict of ``step`` (default the latest), on the CPU, in the
        layout of :meth:`TrainState.state_dict`. An Orbax step (the port's
        or the JAX trainer's) is mapped by :func:`train_state_from_jax`,
        which needs ``param_names``, the student's ``named_parameters()``
        order; the port's also carries its ``port.json``."""
        self.wait()
        step = self.latest_step if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        d = self.directory / str(step)
        if (d / "state.pt").exists():
            return torch.load(d / "state.pt", map_location="cpu", weights_only=True)
        if param_names is None:
            raise ValueError(f"{d} is an Orbax step: restoring it needs param_names")
        from .orbax import read_tree

        out = train_state_from_jax(read_tree(d / "default"), param_names)
        if (d / PORT_MARKER).exists():
            extra = json.loads((d / PORT_MARKER).read_text())
            out.update({k: v for k, v in extra.items() if k != "step"})
        return out
