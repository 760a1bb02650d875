"""The NeRF stack: the reference's stock geometry, renderer, material,
background and system components (port of humangaussian_tpu/nerf).

- implicit-volume geometry (hash-grid or frequency encoding + MLPs,
  `geometry.py`, `encoding.py`) and the SDF family (`sdf.py`: implicit-sdf,
  volume-grid, the NeuS renderer);
- nerf-volume-renderer (`renderer.py`: static-shape stratified ray
  marching with an optional importance pass);
- the backgrounds and materials (`background.py`, `material.py`);
- dreamfusion-system tying them to the SD guidance (`system.py`);
- the mesh exporter with texture baking (`exporter.py`);
- the explicit geometries and mesh renderers (`explicit.py`:
  tetrahedra-sdf-grid with marching tets, custom-mesh, nvdiff-rasterizer,
  patch-renderer, `rasterize_mesh`);
- the GAN renderer and its networks (`gan.py`: gan-volume-renderer).
"""
from humangaussian_torch.nerf.background import (
    NeuralEnvironmentMapBackground,
    SolidColorBackground,
)
from humangaussian_torch.nerf.encoding import (
    FrequencyEncoding,
    HashGridEncoding,
)
from humangaussian_torch.nerf.geometry import (
    ImplicitVolume,
    ImplicitVolumeConfig,
)
from humangaussian_torch.nerf.material import (
    DiffuseWithPointLightMaterial,
    NoMaterial,
)
from humangaussian_torch.nerf.renderer import (
    NerfVolumeRenderer,
    RendererConfig,
)

__all__ = [
    "FrequencyEncoding",
    "HashGridEncoding",
    "ImplicitVolume",
    "ImplicitVolumeConfig",
    "SolidColorBackground",
    "NeuralEnvironmentMapBackground",
    "NoMaterial",
    "DiffuseWithPointLightMaterial",
    "NerfVolumeRenderer",
    "RendererConfig",
]
