"""AdamW with a cosine schedule and global-norm clipping (the port of
``repro/train/optimizer.py``).

The state mirrors the parameters: f32 moments ``mu`` and ``nu`` keyed by
the parameters' dotted names, whatever the parameters' dtype, and an
int32 step. The update is the reference's formula, leaf by leaf in f32:
clip by the global norm, bias corrections in f32, ``delta = mhat /
(sqrt(vhat) + eps) + wd * p`` on every leaf (norms included), and ``p <-
(p_f32 - lr * delta)`` rounded back to the parameter's dtype. There is no
f32 master copy: bf16 parameters are updated in f32 and rounded, as in the
reference. ``torch.optim.AdamW`` is not used: its decoupled decay and its
order of rounding differ.

``apply_updates`` writes the parameters and moments in place (a training
state of several GB is not copied a step) and returns them with a new
state holding the new step.

``state_shapes`` gives the state's shape stand-ins for the dry-run
(meta-device tensors, ``launch/dryrun.py``) and ``state_axes`` their
logical sharding axes: the moments take their parameters' axes, the step
is replicated.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.launch import sharding as shd
from repro_torch.models import layers as ll


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor               # () int32
    mu: dict[str, torch.Tensor]      # f32, keyed like the parameters
    nu: dict[str, torch.Tensor]      # f32, keyed like the parameters


def init_state(params: ll.Params) -> AdamWState:
    """Zero moments on the parameters' device (placed as the parameters
    are where those are DTensors, each rank allocating its shards), step
    0."""
    named = list(params.named_parameters())

    def zeros():
        return {n: torch.zeros_like(p, dtype=torch.float32,
                                    requires_grad=False)
                for n, p in named}

    dev = named[0][1].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=zeros(), nu=zeros())


def state_shapes(params: ll.Params) -> AdamWState:
    """Meta-device stand-ins of ``init_state(params)`` (no allocation)."""
    meta = torch.device("meta")

    def f32():
        return {n: torch.empty(p.shape, dtype=torch.float32, device=meta)
                for n, p in params.named_parameters()}

    return AdamWState(step=torch.empty((), dtype=torch.int32, device=meta),
                      mu=f32(), nu=f32())


def state_axes(param_axes: dict) -> AdamWState:
    return AdamWState(step=None, mu=param_axes, nu=param_axes)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``lr``, then a cosine to ``min_lr_ratio * lr`` at
    ``total_steps``: an f32 scalar tensor."""
    warm = torch.clamp_max(step.float() / max(cfg.warmup_steps, 1), 1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    floor = cfg.min_lr_ratio
    return cfg.lr * warm * (floor + (1.0 - floor) * cos)


def global_norm(grads: dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares. Over
    a mesh (DTensor gradients at their parameters' placements, the mesh
    over every rank of the process group) each rank sums the squares of
    its shards, each leaf's over the ranks that hold a copy of it, and
    one all-reduce over the group adds the ranks' sums: the result a
    replicated DTensor."""
    leaves = list(grads.values())
    if not shd.is_placed(leaves[0]):
        return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in leaves))
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc
    dm = leaves[0].device_mesh
    if dm.size() != dist.get_world_size():
        raise NotImplementedError("a mesh over part of the process group")

    def copies(g):
        return math.prod(dm.size(i) for i, p in enumerate(g.placements)
                         if not p.is_shard())

    local = sum(torch.sum(torch.square(g.to_local().float())) / copies(g)
                for g in leaves)
    total = fc.wait_tensor(fc.all_reduce(local, "sum", dist.group.WORLD))
    return shd.lift(torch.sqrt(total), leaves[0])


@torch.no_grad()
def apply_updates(params: ll.Params, grads: dict[str, torch.Tensor],
                  state: AdamWState, cfg: AdamWConfig
                  ) -> tuple[ll.Params, AdamWState, dict]:
    """One AdamW step over ``grads`` (keyed like the parameters). The
    parameters and moments are updated in place. Returns (params, the new
    state, metrics {grad_norm, lr})."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-12),
                            1.0)
    lr = schedule(cfg, step)
    stepf = step.float()
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, device=stepf.device), stepf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, device=stepf.device), stepf)
    for name, p in params.named_parameters():
        g = grads[name].float() * scale
        m, v = state.mu[name], state.nu[name]
        m.copy_(cfg.b1 * m + (1.0 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1.0 - cfg.b2) * torch.square(g))
        del g
        pf = p.float()
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) \
            + cfg.weight_decay * pf
        p.copy_((pf - lr * delta).to(p.dtype))
    return params, AdamWState(step, state.mu, state.nu), \
        {"grad_norm": gnorm, "lr": lr}
