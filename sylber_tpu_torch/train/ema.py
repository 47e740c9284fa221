"""EMA teacher over a dict of parameter tensors.

Port of ``sylber_tpu/train/ema.py``. The teacher starts as a copy of the
student; ``fp32_shadow`` keeps it in float32 whatever the student's dtype,
so that increments of ``(1 - decay) * param`` do not vanish in bf16. The
update is done in place (``torch._foreach_*``), where JAX builds a new tree;
under FSDP it works on each rank's shards (the EMA and the student are
sharded alike).
"""

from __future__ import annotations

from typing import Dict

import torch

from ..parallel.mesh import local

Params = Dict[str, torch.Tensor]


@torch.no_grad()
def ema_init(params: Params, fp32_shadow: bool = False) -> Params:
    """A detached copy of ``params`` (float leaves in float32 with the shadow)."""
    return {k: (p.detach().float().clone() if fp32_shadow and p.is_floating_point()
                else p.detach().clone()) for k, p in params.items()}


@torch.no_grad()
def ema_update(ema: Params, params: Params, decay: float) -> None:
    """``ema = ema * decay + param * (1 - decay)``, in place, in each EMA
    leaf's dtype: a float32 leaf by ``_foreach`` ops; a narrower one (no
    shadow) with ``decay`` and ``1 - decay`` rounded to its dtype and each
    operation rounded to it, as JAX computes with its weakly typed numbers."""
    keys = [k for k, e in ema.items() if e.is_floating_point()]
    wide = [k for k in keys if ema[k].dtype == torch.float32]
    e = [local(ema[k]) for k in wide]
    if e:
        torch._foreach_mul_(e, decay)
        torch._foreach_add_(e, [local(params[k]).detach().to(ei.dtype) * (1.0 - decay)
                                for k, ei in zip(wide, e)])
    for k in keys:
        if k not in wide:
            ei = local(ema[k])
            keep, take = (torch.tensor(v, dtype=ei.dtype) for v in (decay, 1.0 - decay))
            ei.mul_(keep).add_(local(params[k]).detach().to(ei.dtype) * take)


def ema_restore(ema: Params, params_like: Params) -> Params:
    """The EMA leaves cast back to the student's dtypes."""
    return {k: e.to(params_like[k].dtype) for k, e in ema.items()}
