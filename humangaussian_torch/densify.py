"""Adaptive density control on the padded, fixed-capacity scene.

Port of humangaussian_tpu/densify.py. The scene keeps its padded capacity
and `alive` mask (core/scene.py), and every structural change is a masked
scatter, so slots are allocated exactly as the JAX package allocates them
and state moves one-to-one between the two:

- clone/split children are written into the currently free slots (dead
  slots plus the slots of splitting parents, which die in the same pass),
  in `nonzero` order: all clones first, then the split children;
- pruning clears `alive` bits and parks the opacity logit at -10;
- Adam moments of (re)allocated and killed slots are zeroed.

Semantics (upstream's, quirks included):

- clone: grad >= tau and max(scale) <= percent_dense * extent; the child
  is a verbatim copy.
- split: grad >= tau and max(scale) > percent_dense * extent; N = 2
  children sampled from N(mean, R diag(scale) eps), scale / (0.8 N); the
  parent dies.
- prune inside `densify_and_prune` looks at the POST-densify scene:
  opacity < min_opacity or, when `max_screen_size` is set, world size
  > 0.1 extent (upstream zeroes max_radii2D before this check, so the
  screen-radius branch never fires; it is evaluated against zero radii).
- `prune_only`: opacity < min_opacity or max(scale) > size_thresh;
  survivors keep their gradient statistics.
- both masks come from the pre-densify statistics, so children never
  split in the pass that created them.

When free capacity runs out, children are dropped in append order and
counted in `DensifyInfo.n_dropped`.

The JAX functions are pure; these return new containers whose tensors are
new (no input tensor is written to). The split noise comes from an
explicit `torch.Generator`, or is passed in as `noise` (the parity tests
pass the JAX draw).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from humangaussian_torch.core.scene import GaussianScene, quat_to_rotmat
from humangaussian_torch.utils.profiling import trace_annotation


class DensifyState(NamedTuple):
    """Per-slot densification statistics."""

    grad_accum: torch.Tensor  # [C] sum of ||d loss / d means2d||_2 over steps
    denom: torch.Tensor  # [C] number of steps the Gaussian was visible
    max_radii2d: torch.Tensor  # [C] running max screen radius (pixels)


def init_densify_state(capacity: int, device="cuda") -> DensifyState:
    def z():
        return torch.zeros((capacity,), dtype=torch.float32, device=device)

    return DensifyState(grad_accum=z(), denom=z(), max_radii2d=z())


@torch.no_grad()
def update_stats(
    ds: DensifyState,
    means2d_grad: torch.Tensor,  # [C,2] summed screen-space gradient
    radii: torch.Tensor,  # [C] int32 screen radii from the render
    visible: torch.Tensor,  # [C] bool (radii > 0)
) -> DensifyState:
    gnorm = torch.linalg.norm(means2d_grad[:, :2], dim=-1)
    vis = visible.to(torch.float32)
    return DensifyState(
        grad_accum=ds.grad_accum + gnorm * vis,
        denom=ds.denom + vis,
        max_radii2d=torch.maximum(ds.max_radii2d,
                                  radii.to(torch.float32) * vis),
    )


class DensifyInfo(NamedTuple):
    n_cloned: torch.Tensor
    n_split: torch.Tensor
    n_pruned: torch.Tensor
    n_dropped: torch.Tensor  # children lost to the capacity cap
    n_alive: torch.Tensor


def _scatter_rows(leaf: torch.Tensor, slot: torch.Tensor, values) -> torch.Tensor:
    """A copy of `leaf` with values[i] written at row slot[i]; the sentinel
    slot == C is dropped (jnp's `.at[].set(mode="drop")`)."""
    keep = slot < leaf.shape[0]
    out = leaf.clone()
    # each mask read, and a host value's copy to the card, waits for it
    with trace_annotation("hg.read.densify"):
        rows = slot[keep]
    with trace_annotation("hg.read.densify"):
        out[rows] = values[keep] if isinstance(values, torch.Tensor) \
            else values
    return out


def zero_moments_at(moments, slot: torch.Tensor):
    """Zero the Adam moments at (re)allocated slots. `moments` is a dict
    of dicts of [C, ...] tensors ({"mu": ..., "nu": ...})."""
    return {name: {k: _scatter_rows(v, slot, 0.0) for k, v in group.items()}
            for name, group in moments.items()}


def _kill_slots(scene: GaussianScene, kill: torch.Tensor) -> GaussianScene:
    """Clear alive bits; park dead opacities at the inert default."""
    return scene._replace(
        alive=scene.alive & ~kill,
        opacity_logits=torch.where(kill[:, None], -10.0,
                                   scene.opacity_logits),
    )


def _count(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum().to(torch.int32)


@torch.no_grad()
def densify_and_prune(
    scene: GaussianScene,
    moments,
    ds: DensifyState,
    generator: torch.Generator | None = None,
    *,
    max_grad: float,
    min_opacity: float,
    extent: float,
    max_screen_size: float | None,
    percent_dense: float = 0.01,
    split_n: int = 2,
    noise: torch.Tensor | None = None,
):
    """One clone + split + prune pass.

    `noise` [split_n * C, 3] is the standard-normal draw of the split
    offsets; when None it is drawn from `generator`.
    Returns (scene, moments, densify_state, info).
    """
    c = scene.capacity
    dev = scene.device
    arange = torch.arange(c, device=dev)
    alive = scene.alive
    scales = scene.scales
    max_scale = scales.amax(dim=-1)

    grads = torch.where(ds.denom > 0,
                        ds.grad_accum / torch.clamp_min(ds.denom, 1.0), 0.0)
    grad_hit = alive & (grads >= max_grad)
    clone_mask = grad_hit & (max_scale <= percent_dense * extent)
    split_mask = grad_hit & (max_scale > percent_dense * extent)

    # ---- children (append order: clones, then the split children) ------
    parent = arange.repeat(1 + split_n)  # [reps*C]
    valid = torch.cat([clone_mask] + [split_mask] * split_n)
    is_split = torch.cat([torch.zeros(c, dtype=torch.bool, device=dev),
                          torch.ones(split_n * c, dtype=torch.bool,
                                     device=dev)])

    if noise is None:
        noise = torch.randn((split_n * c, 3), generator=generator,
                            device=dev, dtype=torch.float32)
    eps = noise.to(dev, torch.float32) * scales.repeat(split_n, 1)
    rot = quat_to_rotmat(scene.rotations)  # [C,3,3]
    offsets = torch.einsum("nij,nj->ni", rot.repeat(split_n, 1, 1), eps)
    offsets = torch.cat([torch.zeros((c, 3), dtype=torch.float32,
                                     device=dev), offsets])

    params = scene.params()
    child = {k: p[parent] for k, p in params.items()}
    child["means"] = child["means"] + offsets
    child["log_scales"] = torch.where(
        is_split[:, None],
        child["log_scales"] - torch.log(torch.tensor(0.8 * split_n)).item(),
        child["log_scales"])

    # ---- slot allocation ------------------------------------------------
    free_mask = ~alive | split_mask  # split parents die this pass
    with trace_annotation("hg.read.densify"):
        free_slots = torch.nonzero(free_mask)[:, 0]
    num_free = free_slots.shape[0]
    free_slots = torch.cat([free_slots,
                            torch.full((c - num_free,), c, device=dev)])
    child_rank = torch.cumsum(valid.to(torch.int64), dim=0) - 1
    child_ok = valid & (child_rank < num_free)
    slot = torch.where(child_ok, free_slots[child_rank.clamp(0, c - 1)], c)

    new_params = {k: _scatter_rows(params[k], slot, child[k]) for k in params}
    new_alive = _scatter_rows(alive & ~split_mask, slot, True)
    scene = scene.replace_params(new_params)._replace(alive=new_alive)
    moments = zero_moments_at(moments, slot)

    # ---- prune on the post-densify scene (radii stats just reset) -------
    prune = scene.alive & (scene.opacities[:, 0] < min_opacity)
    if max_screen_size is not None:
        post_reset_radii = torch.zeros((c,), dtype=torch.float32, device=dev)
        prune = prune | (
            scene.alive
            & ((post_reset_radii > max_screen_size)
               | (scene.scales.amax(dim=-1) > 0.1 * extent))
        )
    scene = _kill_slots(scene, prune)
    moments = zero_moments_at(moments, torch.where(prune, arange, c))

    info = DensifyInfo(
        n_cloned=_count(child_ok & ~is_split),
        n_split=_count(split_mask),
        n_pruned=_count(prune),
        n_dropped=_count(valid & ~child_ok),
        n_alive=_count(scene.alive),
    )
    return scene, moments, init_densify_state(c, dev), info


@torch.no_grad()
def prune_only(
    scene: GaussianScene,
    moments,
    ds: DensifyState,
    *,
    min_opacity: float = 0.005,
    size_thresh: float = 0.008,
):
    """Floater removal. Survivors keep their gradient statistics.
    Returns (scene, moments, densify_state, info)."""
    c = scene.capacity
    dev = scene.device
    prune = scene.alive & (
        (scene.opacities[:, 0] < min_opacity)
        | (scene.scales.amax(dim=-1) > size_thresh)
    )
    scene = _kill_slots(scene, prune)
    moments = zero_moments_at(
        moments, torch.where(prune, torch.arange(c, device=dev), c))
    keepf = (~prune).to(torch.float32)
    ds = DensifyState(
        grad_accum=ds.grad_accum * keepf,
        denom=ds.denom * keepf,
        max_radii2d=ds.max_radii2d * keepf,
    )
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    info = DensifyInfo(
        n_cloned=zero,
        n_split=zero,
        n_pruned=_count(prune),
        n_dropped=zero,
        n_alive=_count(scene.alive),
    )
    return scene, moments, ds, info
