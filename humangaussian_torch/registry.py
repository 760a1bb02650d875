"""Component registry: name -> constructor, as the reference's
threestudio.register / find.

Port of humangaussian_tpu/registry.py (plain Python, kept as a copy): the
same names, each resolving to the port's counterpart. The built-ins are
imported lazily, on the first `find` of an unknown name or on `names()`,
so importing the registry stays cheap. The launcher (apps/launch.py)
dispatches on `system.type` itself and does not go through it.
"""
from __future__ import annotations

from typing import Callable

_REGISTRY: dict[str, Callable] = {}


def register(name: str):
    def decorator(cls):
        if name in _REGISTRY and _REGISTRY[name] is not cls:
            raise ValueError(f"duplicate registry name {name!r}")
        _REGISTRY[name] = cls
        return cls

    return decorator


def find(name: str) -> Callable:
    if name not in _REGISTRY:
        _register_builtins()
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown component {name!r}; known: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name]


def names() -> list[str]:
    _register_builtins()
    return sorted(_REGISTRY)


_BUILTINS_DONE = False


def _register_builtins():
    global _BUILTINS_DONE
    if _BUILTINS_DONE:
        return
    _BUILTINS_DONE = True
    from humangaussian_torch.data.cameras import RandomCameraConfig
    from humangaussian_torch.data.co3d import Co3dDataModule
    from humangaussian_torch.data.image import SingleImageDataModule
    from humangaussian_torch.data.multiview import MultiviewDataModule
    from humangaussian_torch.guidance.controlnet import ControlNetGuidance
    from humangaussian_torch.guidance.deep_floyd import DeepFloydGuidance
    from humangaussian_torch.guidance.dual_branch import DualBranchGuidance
    from humangaussian_torch.guidance.prompt import (
        DummyPromptProcessor,
        PromptProcessor,
    )
    from humangaussian_torch.guidance.stable_diffusion import (
        StableDiffusionGuidance,
    )
    from humangaussian_torch.nerf.background import (
        NeuralEnvironmentMapBackground,
        SolidColorBackground,
        TexturedBackground,
    )
    from humangaussian_torch.nerf.explicit import (
        CustomMesh,
        NVDiffRasterizer,
        PatchRenderer,
        TetrahedraSDFGrid,
    )
    from humangaussian_torch.nerf.exporter import export_implicit_volume
    from humangaussian_torch.nerf.gan import GANVolumeRenderer
    from humangaussian_torch.nerf.geometry import ImplicitVolume
    from humangaussian_torch.nerf.material import (
        DiffuseWithPointLightMaterial,
        HybridRGBLatentMaterial,
        NeuralRadianceMaterial,
        NoMaterial,
        PBRMaterial,
        SDLatentAdapterMaterial,
    )
    from humangaussian_torch.nerf.renderer import NerfVolumeRenderer
    from humangaussian_torch.nerf.sdf import (
        ImplicitSDF,
        NeusVolumeRenderer,
        VolumeGrid,
    )
    from humangaussian_torch.nerf.system import DreamFusionSystem
    from humangaussian_torch.train.photo import PhotoTrainer
    from humangaussian_torch.train.system import GaussianDreamerSystem

    for name, obj in (
        ("gaussiandreamer-system", GaussianDreamerSystem),
        ("dual-branch-guidance", DualBranchGuidance),
        ("stable-diffusion-guidance", StableDiffusionGuidance),
        ("deep-floyd-guidance", DeepFloydGuidance),
        ("deep-floyd-prompt-processor", PromptProcessor),
        ("texture-structure-prompt-processor", PromptProcessor),
        ("stable-diffusion-prompt-processor", PromptProcessor),
        ("random-camera-datamodule", RandomCameraConfig),
        ("photo-3dgs-trainer", PhotoTrainer),
        ("co3d-datamodule", Co3dDataModule),
        ("single-image-datamodule", SingleImageDataModule),
        ("multiview-camera-datamodule", MultiviewDataModule),
        ("implicit-volume", ImplicitVolume),
        ("nerf-volume-renderer", NerfVolumeRenderer),
        ("solid-color-background", SolidColorBackground),
        ("neural-environment-map-background",
         NeuralEnvironmentMapBackground),
        ("no-material", NoMaterial),
        ("diffuse-with-point-light-material", DiffuseWithPointLightMaterial),
        ("dreamfusion-system", DreamFusionSystem),
        ("mesh-exporter", export_implicit_volume),
        ("implicit-sdf", ImplicitSDF),
        ("volume-grid", VolumeGrid),
        ("neus-volume-renderer", NeusVolumeRenderer),
        ("neural-radiance-material", NeuralRadianceMaterial),
        ("pbr-material", PBRMaterial),
        ("textured-background", TexturedBackground),
        ("stable-diffusion-controlnet-guidance", ControlNetGuidance),
        ("dummy-prompt-processor", DummyPromptProcessor),
        ("custom-mesh", CustomMesh),
        ("tetrahedra-sdf-grid", TetrahedraSDFGrid),
        ("nvdiff-rasterizer", NVDiffRasterizer),
        ("patch-renderer", PatchRenderer),
        ("sd-latent-adapter-material", SDLatentAdapterMaterial),
        ("hybrid-rgb-latent-material", HybridRGBLatentMaterial),
        ("gan-volume-renderer", GANVolumeRenderer),
    ):
        _REGISTRY.setdefault(name, obj)
