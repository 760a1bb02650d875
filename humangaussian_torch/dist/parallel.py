"""Multi-process training: camera data parallelism over torch.distributed.

Port of humangaussian_tpu/dist/parallel.py. The reference trains on one
GPU; the JAX package shards the camera batch across a device mesh with
`shard_map`. Here each process (one a card, launched by torchrun) is a
rank of a process group:

  every rank: draws the whole batch's step inputs and guidance noise from
              the replicated generator (in train_step's order), renders
              and guides its b / n cameras (its rows), and takes the
              gradients of its shard's loss (`batch_loss` with the group:
              the depth maximum is an all-reduce MAX, the SDS loss is
              rescaled to the whole batch, the mean losses divided by n)
  all-reduce SUM: the parameter gradients, the means2d gradient, the loss
              and its three terms
  all-reduce MAX: the per-Gaussian radii, grad_norm, overflow and
              overflow_spill

Everything after the all-reduce (Adam, the densify statistics, density
control) runs replicated: every rank applies identical updates to
identical inputs, so the scenes stay equal with no more communication
(lock-step densification). The generator's state after a step is the
single-process step's, because every rank makes the whole batch's draws;
the JAX package gets the same invariance from per-sample keys
(`per_sample_normal`), which a torch generator cannot replay. The step
passes the state's `tile_cap` to the render, as `train_step` does (the
JAX step leaves it out).

The one H100 runs this at world size 1 (NCCL); the CPU tests run two
gloo ranks.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from humangaussian_torch.train.system import StepInputs

_TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def multihost_init() -> bool:
    """`torch.distributed.init_process_group` from torchrun's variables
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK; LOCAL_RANK picks the
    card), the counterparts of the JAX package's JAX_COORDINATOR_ADDRESS
    (address and port), JAX_NUM_PROCESSES and JAX_PROCESS_ID. The backend
    is NCCL when a card is present and gloo otherwise. Without those
    variables it does nothing and returns False; it returns True once a
    group is up (also when one already was)."""
    if not all(k in os.environ for k in _TORCHRUN_VARS):
        return False
    if dist.is_initialized():
        return True
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(
        backend,
        init_method=(f"tcp://{os.environ['MASTER_ADDR']}:"
                     f"{os.environ['MASTER_PORT']}"),
        world_size=int(os.environ["WORLD_SIZE"]),
        rank=int(os.environ["RANK"]))
    return True


def _rows(x, rows: slice):
    """The batch rows of a tensor, or of every tensor in a dict / list."""
    if isinstance(x, dict):
        return {k: _rows(v, rows) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_rows(v, rows) for v in x]
    return x[rows]


def shard_inputs(inputs: StepInputs, b: int, rows: slice) -> StepInputs:
    """A rank's rows of the whole batch's step inputs: every per-camera
    field, the pose images, the timesteps, the guidance draws, and each of
    the three [cond | neg | null] segments of the text (and of the pooled
    rows)."""
    cams = inputs.cameras
    cams = cams._replace(**{
        k: v[rows] for k, v in cams._asdict().items()
        if isinstance(v, torch.Tensor) and v.dim() > 0 and v.shape[0] == b})
    text = torch.cat([seg[rows] for seg in inputs.text.split(b)])
    pooled = (None if inputs.pooled is None else
              torch.cat([seg[rows] for seg in inputs.pooled.split(b)]))
    return StepInputs(cameras=cams, pose=inputs.pose[rows], text=text,
                      t=inputs.t[rows],
                      guidance_draws=_rows(inputs.guidance_draws, rows),
                      pooled=pooled)


def _all_reduce(tensors: list, op, group) -> list:
    """One all-reduce of the tensors, flattened into a float32 buffer;
    each comes back in its shape and dtype."""
    flat = torch.cat([t.detach().reshape(-1).to(torch.float32)
                      for t in tensors])
    dist.all_reduce(flat, op, group=group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape).to(t.dtype))
        at += t.numel()
    return out


def make_dp_train_step(system, group=None):
    """A camera-data-parallel `train_step` of `system` over the process
    group `group` (None: the default group): `step(state, inputs=None)`
    with train_step's signature, semantics and generator stream; every
    rank returns the same state and metrics."""
    if group is None:
        group = dist.group.WORLD
    n = dist.get_world_size(group)
    rank = dist.get_rank(group)
    b = system.camera_cfg.batch_size
    if b % n:
        raise ValueError(f"batch {b} is not divisible by the world size {n}")
    lb = b // n
    rows = slice(rank * lb, (rank + 1) * lb)

    def dp_train_step(state, inputs: StepInputs | None = None):
        if inputs is None:
            inputs = system.sample_step_inputs(state)
        if inputs.guidance_draws is None:
            inputs = inputs._replace(guidance_draws=system.guidance.step_draws(
                b, state.generator))
        loss, aux, grads, means2d_grad = system.loss_and_grads(
            state, shard_inputs(inputs, b, rows), group=group, n_shards=n,
            global_batch=b)
        names = list(grads)
        summed = _all_reduce(
            [grads[k] for k in names] + [means2d_grad, loss, aux["loss_sds"],
                                         aux["loss_sparsity"],
                                         aux["loss_opaque"]],
            dist.ReduceOp.SUM, group)
        maxed = _all_reduce(
            [aux["radii"], aux["grad_norm"],
             torch.as_tensor(aux["overflow"], device=loss.device),
             torch.as_tensor(aux["overflow_spill"], device=loss.device)],
            dist.ReduceOp.MAX, group)
        k = len(names)
        aux = dict(zip(("loss_sds", "loss_sparsity", "loss_opaque"),
                       summed[k + 2:]))
        aux.update(zip(("radii", "grad_norm", "overflow", "overflow_spill"),
                       maxed))
        return system.apply_grads(state, summed[k + 1], aux,
                                  dict(zip(names, summed[:k])), summed[k])

    return dp_train_step
