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
:class:`TrainCheckpointManager` keeps the trainer's rolling step
directories (``torch.save``), the port's counterpart of the JAX package's
Orbax manager, and resumes from either (``io/orbax.py`` reads the JAX
trainer's steps and ``params_final`` without JAX).
"""

from __future__ import annotations

import os
import re
import shutil
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
                         transposed=None) -> Dict[str, Any]:
    """The flax tree (nested dicts of float32 numpy arrays) of a port state
    dict: the inverse of :func:`state_dict_from_tree`."""
    tree: Dict[str, Any] = {}
    for key, t in sd.items():
        a = t.detach().float().cpu().numpy()
        for pattern, repl in renames:
            key = pattern.sub(repl, key)
        *path, leaf = key.split(".")
        if leaf == "weight":
            if a.ndim == 2:      # Linear (out, in) -> Dense (in, out)
                leaf, a = "kernel", a.T
            elif transposed is not None and transposed.match(".".join(path) + "."):
                leaf, a = "kernel", np.transpose(a, (2, 0, 1))[::-1]
            elif a.ndim == 3:    # Conv1d (out, in/groups, k) -> (k, in/groups, out)
                leaf, a = "kernel", np.transpose(a, (2, 1, 0))
            elif a.ndim == 4:    # Conv2d (out, in, kh, kw) -> (kh, kw, in, out)
                leaf, a = "kernel", np.transpose(a, (2, 3, 1, 0))
            else:                # LayerNorm / GroupNorm
                leaf = "scale"
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(a)
    return tree


def state_dict_from_jax_params(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's HubertModel state dict from the JAX ``HubertModel`` tree."""
    return state_dict_from_tree(tree, _RENAMES)


def jax_params_from_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The JAX ``HubertModel`` tree (nested dicts of float32 numpy arrays,
    flax layouts) from the port's state dict: the inverse of
    :func:`state_dict_from_jax_params`."""
    return tree_from_state_dict(sd, _INVERSE_RENAMES)


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
                thresholder=tuple(torch.tensor(np.asarray(thr[k], np.float32)) for k in
                                  ("signal_mean", "signal_var", "noise_mean", "noise_var",
                                   "fixed")),
                acc_grads=acc)


class TrainCheckpointManager:
    """Rolling train-state checkpoints with resume.

    A save writes ``<directory>/<step>/state.pt`` (``torch.save`` of a dict
    of tensors, numbers and containers) through a temporary directory that
    is renamed when complete, so a run killed during a save leaves no step
    that ``latest_step`` would pick up. The ``max_to_keep`` newest of these
    steps are kept. Saves are synchronous; the caller decides when one is
    due, so the state is copied to the host only then.

    The directory may also hold steps the JAX trainer wrote
    (``<step>/default``, Orbax): :meth:`restore` reads those too, without
    JAX (:func:`train_state_from_jax`), and the newest step wins, whichever
    trainer wrote it (the port's at a tie). Pruning leaves them alone. A run
    resumed from a JAX step continues its parameters, EMA, AdamW moments,
    step count and thresholder; the batches after the resume are the
    port's, drawn from ``(seed, step)`` (``train/loop.py``; intended
    differences (n) and (o) in ``ROADMAP.md`` section 3), not the JAX
    loop's.
    """

    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = Path(directory)
        self.max_to_keep = max_to_keep
        self.directory.mkdir(parents=True, exist_ok=True)

    def _steps(self, marker: str):
        return sorted(int(d.name) for d in self.directory.iterdir()
                      if d.name.isdigit() and (d / marker).exists())

    def steps(self):
        """Every step saved, by either trainer."""
        return sorted(set(self._steps("state.pt")) | set(self._steps("default/_METADATA")))

    @property
    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Mapping[str, Any]) -> None:
        tmp = self.directory / f".{step}.tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        torch.save(state, tmp / "state.pt")
        final = self.directory / str(step)
        if (final / "default").exists():
            raise FileExistsError(f"{final} holds a JAX trainer's step; not overwritten")
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in self._steps("state.pt")[:-self.max_to_keep]:
            shutil.rmtree(self.directory / str(old), ignore_errors=True)

    def restore(self, step: Optional[int] = None, param_names=None) -> Dict[str, Any]:
        """The saved dict of ``step`` (default the latest), on the CPU. A
        JAX trainer's step is mapped by :func:`train_state_from_jax`, which
        needs ``param_names``, the student's ``named_parameters()`` order."""
        step = self.latest_step if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        d = self.directory / str(step)
        if (d / "state.pt").exists():
            return torch.load(d / "state.pt", map_location="cpu", weights_only=True)
        if param_names is None:
            raise ValueError(f"{d} is a JAX trainer's step: restoring it needs param_names")
        from .orbax import read_tree

        return train_state_from_jax(read_tree(d / "default"), param_names)
