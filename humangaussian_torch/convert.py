"""Carry state from numpy (or the JAX package's containers) into the port.

`scene_from_numpy` turns the fields of a JAX `GaussianScene` (means,
log_scales, quats, sh_dc, sh_rest, opacity_logits, alive), given as a
mapping or a NamedTuple of array-likes, into the port's GaussianScene;
`smplx_from_numpy` does the same for an `SMPLXModel`, and
`adam_state_from_numpy`, `densify_state_from_numpy` and
`photo_state_from_numpy` for the training state (JAX `AdamState`,
`DensifyState`, `PhotoTrainState` given as numpy leaves); the
`*_from_flax` functions carry Flax parameter trees (the UNet, the
ControlNet, the VAE, LPIPS, the NeRF modules, the tetrahedral grid and
the custom mesh, the GAN networks) into the port's state dicts. The parity tests
use them so that the two packages compute on identical state. Nothing
here imports JAX: arrays are read through `numpy.asarray`.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from humangaussian_torch import resolve_device
from humangaussian_torch.core.scene import GaussianScene
from humangaussian_torch.densify import DensifyState
from humangaussian_torch.smplx.model import SMPLXModel
from humangaussian_torch.train.optim import AdamState
from humangaussian_torch.train.photo import PhotoTrainState


def _fields(d) -> dict:
    return dict(d._asdict()) if hasattr(d, "_asdict") else dict(d)


def scene_from_numpy(d, device="cuda") -> GaussianScene:
    dev = resolve_device(device)
    f = _fields(d)

    def t(name, dtype=torch.float32):
        return torch.from_numpy(np.array(f[name])).to(dev, dtype)

    return GaussianScene(
        means=t("means"),
        log_scales=t("log_scales"),
        quats=t("quats"),
        sh_dc=t("sh_dc"),
        sh_rest=t("sh_rest"),
        opacity_logits=t("opacity_logits"),
        alive=t("alive", torch.bool),
    )


def smplx_from_numpy(d, device="cuda") -> SMPLXModel:
    """SMPLXModel with tensor fields on `device` (`parents` stays numpy:
    the kinematic loop indexes with it)."""
    dev = resolve_device(device)
    f = _fields(d)

    def t(name, dtype=torch.float32):
        return torch.from_numpy(np.array(f[name])).to(dev, dtype)

    return SMPLXModel(
        v_template=t("v_template"),
        shapedirs=t("shapedirs"),
        exprdirs=t("exprdirs"),
        posedirs=t("posedirs"),
        j_regressor=t("j_regressor"),
        lbs_weights=t("lbs_weights"),
        parents=np.asarray(f["parents"], np.int32),
        faces=t("faces", torch.int64),
        landmark_vertex_ids=t("landmark_vertex_ids", torch.int64),
        hands_mean=t("hands_mean"),
    )


def _f32(x, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32)).to(dev)


def adam_state_from_numpy(d, device="cuda") -> AdamState:
    """AdamState from {mu: {name: array}, nu: {...}, count}."""
    dev = resolve_device(device)
    f = _fields(d)
    return AdamState(
        mu={k: _f32(v, dev) for k, v in f["mu"].items()},
        nu={k: _f32(v, dev) for k, v in f["nu"].items()},
        count=int(f["count"]),
    )


def densify_state_from_numpy(d, device="cuda") -> DensifyState:
    dev = resolve_device(device)
    f = _fields(d)
    return DensifyState(
        grad_accum=_f32(f["grad_accum"], dev),
        denom=_f32(f["denom"], dev),
        max_radii2d=_f32(f["max_radii2d"], dev),
    )


def photo_state_from_numpy(d, device="cuda", seed: int = 0) -> PhotoTrainState:
    """PhotoTrainState from the JAX state's numpy leaves {scene, adam,
    densify, step, active_sh_degree}. The JAX PRNG key has no torch
    counterpart: the split-noise generator is seeded with `seed`."""
    dev = resolve_device(device)
    f = _fields(d)
    return PhotoTrainState(
        scene=scene_from_numpy(f["scene"], dev),
        adam=adam_state_from_numpy(f["adam"], dev),
        densify=densify_state_from_numpy(f["densify"], dev),
        step=int(f["step"]),
        generator=torch.Generator(device=dev).manual_seed(seed),
        active_sh_degree=int(f["active_sh_degree"]),
    )


# ---- the guidance: Flax parameter trees -> diffusers-named tensors --------


def _torch_leaf(path_leaf: str, value) -> torch.Tensor:
    """A Flax leaf as its torch tensor: conv kernels [kh, kw, I, O] ->
    [O, I, kh, kw], dense kernels [I, O] -> [O, I], the rest as it is."""
    a = np.asarray(value, np.float32)
    if path_leaf == "kernel":
        a = np.transpose(a, (3, 2, 0, 1)) if a.ndim == 4 else np.transpose(a)
    return torch.from_numpy(np.ascontiguousarray(a))


_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "bias": "bias"}


def _flatten(tree: dict, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _params(leaves: dict) -> dict:
    return leaves["params"] if "params" in leaves else leaves


def _transformer_key(rest) -> str:
    """Path inside a Transformer2D module -> diffusers' suffix."""
    if rest[0] != "block_0":  # norm, proj_in, proj_out
        return ".".join(rest)
    inner = list(rest[1:])
    if inner[0] == "ff":
        inner[1] = {"proj_in": "net.0.proj", "proj_out": "net.2"}[inner[1]]
    elif inner[0].startswith("attn") and inner[1] == "to_out":
        inner[1] = "to_out.0"
    return "transformer_blocks.0." + ".".join(inner)


def unet_state_dict_from_flax(leaves: dict) -> dict:
    """A Flax `DualBranchUNet` or `SingleUNet` parameter tree (numpy
    leaves, with or without the top-level "params") as a diffusers-named
    state dict of float32 tensors, the inverse of the JAX package's torch
    -> Flax converter. Branch i >= 1 of a `branch_num > 1` tree (Flax
    names `conv_in_branch1`, `down_block_branch1_0`, `head_branch1`, ...)
    becomes `*_branch.{i}`; `fusion_conv` and `encoder_hid_proj` keep
    their names. The number of levels and of branch up blocks is read off
    the tree."""
    params = _params(leaves)
    n_levels = sum(1 for k in params if re.fullmatch(r"down_block_\d+", k))
    n_last = sum(1 for k in params if re.fullmatch(r"up_block_branch_\d+", k))
    sd = {}
    for path, value in _flatten(params):
        top, rest = path[0], list(path[1:])
        leaf = _LEAF_NAMES[rest[-1]] if rest else None
        m = re.fullmatch(
            r"(down_block|up_block)(?:_branch(\d*))?_(\d+)", top)
        if top in ("time_embedding", "add_embedding", "conv_in",
                   "fusion_conv", "encoder_hid_proj"):
            key = ".".join([top, *rest[:-1], leaf])
        elif top.startswith("conv_in_branch"):
            key = f"conv_in_branch.{int(top[14:] or 0)}.{leaf}"
        elif top == "head":
            key = f"{rest[0]}.{leaf}"
        elif top.startswith("head_branch"):
            key = f"{rest[0]}_branch.{int(top[11:] or 0)}.{leaf}"
        elif m or top == "mid_block":
            if top == "mid_block":
                prefix = "mid_block"
            else:
                family, branch, idx = m.groups()
                idx = int(idx)
                prefix = f"{family}s"
                if branch is not None:
                    prefix += f"_branch.{int(branch or 0)}"
                    if family == "up_block":
                        idx -= n_levels - n_last
                prefix += f".{idx}"
            sub, inner = rest[0], rest[1:-1]
            if sub.startswith("resnet_"):
                body = f"resnets.{sub[7:]}." + ".".join(inner)
            elif sub.startswith("attn_"):
                body = f"attentions.{sub[5:]}." + _transformer_key(inner)
            else:  # downsample / upsample
                body = f"{sub}rs.0.conv"
            key = f"{prefix}.{body}.{leaf}"
        else:
            raise KeyError(f"no diffusers name for {'/'.join(path)}")
        sd[key] = _torch_leaf(rest[-1], value)
    return sd


def controlnet_state_dict_from_flax(leaves: dict) -> dict:
    """A Flax `ControlNet` parameter tree (numpy leaves) as the port's
    diffusers-named `ControlNet` state dict: the trunk (conv_in,
    time_embedding, down_block_i, mid_block) as `unet_state_dict_from_flax`
    names it, `cond_conv_in` / `cond_conv_out` as
    `controlnet_cond_embedding.conv_in` / `conv_out`, `cond_block_{i}a` /
    `b` as `controlnet_cond_embedding.blocks.{2i}` / `{2i + 1}`,
    `controlnet_down_block_{i}` as `controlnet_down_blocks.{i}`. (The
    embedding's shapes carry over where consecutive embedding widths are
    equal: guidance/controlnet.py.)"""
    params = _params(leaves)
    trunk, sd = {}, {}
    for top, sub in params.items():
        m = re.fullmatch(r"cond_block_(\d+)([ab])", top)
        if m:
            name = ("controlnet_cond_embedding.blocks."
                    f"{2 * int(m.group(1)) + (m.group(2) == 'b')}")
        elif top in ("cond_conv_in", "cond_conv_out"):
            name = f"controlnet_cond_embedding.{top[5:]}"
        elif top.startswith("controlnet_down_block_"):
            name = f"controlnet_down_blocks.{top[22:]}"
        elif top == "controlnet_mid_block":
            name = top
        else:
            trunk[top] = sub
            continue
        for leaf, value in sub.items():
            sd[f"{name}.{_LEAF_NAMES[leaf]}"] = _torch_leaf(leaf, value)
    sd.update(unet_state_dict_from_flax(trunk))
    return sd


def vae_state_dict_from_flax(leaves: dict) -> dict:
    """A Flax `AutoencoderKL` parameter tree (numpy leaves) as a
    diffusers-named state dict of float32 tensors."""
    sd = {}
    for path, value in _flatten(_params(leaves)):
        leaf = _LEAF_NAMES[path[-1]]
        if path[0] in ("quant_conv", "post_quant_conv"):
            key = f"{path[0]}.{leaf}"
        else:
            side, mod, inner = path[0], path[1], list(path[2:-1])
            m = re.fullmatch(r"(down|up)_(\d+)_(resnet_(\d+)|\w+sample)", mod)
            if m:
                tag, idx, what, j = m.groups()
                body = (f"resnets.{j}." + ".".join(inner) if j is not None
                        else f"{what}rs.0.conv")
                key = f"{side}.{tag}_blocks.{idx}.{body}.{leaf}"
            elif mod.startswith("mid_resnet_"):
                key = (f"{side}.mid_block.resnets.{mod[11:]}."
                       + ".".join(inner) + f".{leaf}")
            elif mod == "mid_attn":
                name = "to_out.0" if inner[0] == "to_out" else inner[0]
                key = f"{side}.mid_block.attentions.0.{name}.{leaf}"
            else:  # conv_in, conv_norm_out, conv_out
                key = f"{side}.{mod}.{leaf}"
        sd[key] = _torch_leaf(path[-1], value)
    return sd


def lpips_state_dict_from_flax(leaves: dict) -> dict:
    """A Flax `LPIPS` parameter tree (numpy leaves: `vgg/conv_{i}` and
    `lin_{i}`) as the port's `LPIPS` state dict of float32 tensors."""
    from humangaussian_torch.perceptual import VGG_CONV_IDS

    sd = {}
    for path, value in _flatten(_params(leaves)):
        leaf = _LEAF_NAMES[path[-1]]
        if path[0] == "vgg":
            key = f"vgg.features.{VGG_CONV_IDS[int(path[1][5:])]}.{leaf}"
        else:
            key = f"lin{int(path[0][4:])}.{leaf}"
        sd[key] = _torch_leaf(path[-1], value)
    return sd


def nerf_state_dict_from_flax(leaves: dict) -> dict:
    """A Flax NeRF parameter tree (numpy leaves) as the state dict of the
    port's module: one module's tree (`geometry.init(...)`) for that
    module, or a renderer's {geometry, material, background[, variance]}
    for its `field`. Every "params" level is dropped; a Dense `kernel`
    [in, out] becomes `weight` [out, in] and `bias` copies; the hash
    `table`, `env_color`, `texture`, `adapter` and `grid` copy as they
    are; an inline MLP `VanillaMLP_0` is the port's `mlp`; the NeuS
    renderer's top-level `variance` is `variance.variance`."""
    sd = {}
    for path, value in _flatten(leaves):
        names = ["mlp" if p == "VanillaMLP_0" else p
                 for p in path if p != "params"]
        if names == ["variance"]:
            names = ["variance", "variance"]
        if names[-1] == "kernel":
            names[-1] = "weight"
        sd[".".join(names)] = _torch_leaf(path[-1], value)
    return sd


# TetrahedraSDFGrid's tree ({sdf, deformation, encoding: {table},
# feature_network: {hidden_i, out}}) and CustomMesh's ({encoding,
# feature_network}) carry over by the same rules
tet_sdf_state_dict_from_flax = nerf_state_dict_from_flax
custom_mesh_state_dict_from_flax = nerf_state_dict_from_flax

# Flax's automatic submodule names in the GAN networks -> the port's
_GRES_NAMES = {"GroupNorm_0": "norm1", "Conv_0": "conv1",
               "Dense_0": "temb_proj", "GroupNorm_1": "norm2",
               "Conv_1": "conv2", "Conv_2": "nin_shortcut"}
_BNECK_NAMES = {"Conv_0": "expand", "GroupNorm_0": "norm_expand",
                "Conv_1": "depthwise", "GroupNorm_1": "norm_depthwise",
                "Dense_0": "se_reduce", "Dense_1": "se_expand",
                "Conv_2": "project", "GroupNorm_2": "norm_project"}
_GLOBAL_NAMES = {"Conv_0": "conv_stem", "GroupNorm_0": "norm_stem",
                 "Conv_1": "conv_head", "GroupNorm_1": "norm_head",
                 "Dense_0": "fc1", "Dense_1": "fc2"}


def _gan_names(kind: str, tree: dict) -> dict:
    """Flax name of each direct submodule of a `kind` network -> the
    port's attribute path."""
    convs = sorted((k for k in tree if k.startswith("Conv_")),
                   key=lambda k: int(k[5:]))
    names = {}
    for key in tree:
        idx = int(key.rsplit("_", 1)[1])
        if kind in ("generator", "local_encoder"):
            if key.startswith("GResBlock_"):
                names[key] = f"blocks.{idx}"
            elif key == "GroupNorm_0":
                names[key] = "norm_out"
            elif key == convs[0]:
                names[key] = "conv_in"
            elif key == convs[-1]:
                names[key] = "conv_out"
            else:
                names[key] = f"resamples.{idx - 1}"
        elif kind == "global_encoder":
            names[key] = (f"blocks.{idx}" if key.startswith("_Inverted")
                          else _GLOBAL_NAMES[key])
        elif kind == "discriminator":
            if key.startswith("GroupNorm_"):
                names[key] = f"norms.{idx}"
            elif key == convs[0]:
                names[key] = "conv_in"
            elif key == convs[-1]:
                names[key] = "conv_out"
            else:
                names[key] = f"convs.{idx - 1}"
        else:
            raise KeyError(f"unknown GAN network {kind!r}")
    return names


def gan_state_dict_from_flax(leaves: dict, kind: str | None = None) -> dict:
    """The GAN networks' Flax trees (numpy leaves) as the port's state
    dict: {generator, local_encoder, global_encoder, discriminator} trees
    (as `GANVolumeRenderer.init_params` returns them, "base" ignored) for
    `GANVolumeRenderer.nets`, or one network's tree with `kind` naming it
    for that module. Flax's automatic names (`Conv_i`, `GroupNorm_i`,
    `Dense_i`, `GResBlock_i`, `_InvertedResidual_i`) map to the port's
    by their order of creation."""
    if kind is None:
        sd = {}
        for name in ("generator", "local_encoder", "global_encoder",
                     "discriminator"):
            sd.update({f"{name}.{k}": v for k, v in gan_state_dict_from_flax(
                leaves[name], name).items()})
        return sd
    tree = _params(leaves)
    sd = {}
    for key, name in _gan_names(kind, tree).items():
        inner = {"GResBlock": _GRES_NAMES, "_InvertedResidual": _BNECK_NAMES}
        sub_map = inner.get(key.rsplit("_", 1)[0])
        for path, value in _flatten(tree[key]):
            parts = [name]
            if sub_map is not None:
                parts.append(sub_map[path[0]])
                path = path[1:]
            parts.append(_LEAF_NAMES[path[-1]])
            sd[".".join(parts)] = _torch_leaf(path[-1], value)
    return sd


def prompt_embeddings_from_numpy(d, device="cuda"):
    """PromptEmbeddings from the fields of the JAX package's (text_vd,
    uncond_vd, text, uncond, null), given as a mapping or a NamedTuple."""
    from humangaussian_torch.guidance.prompt import PromptEmbeddings

    dev = resolve_device(device)
    f = _fields(d)
    return PromptEmbeddings(**{
        k: _f32(f[k], dev) for k in PromptEmbeddings._fields
        if k != "pooled"})
