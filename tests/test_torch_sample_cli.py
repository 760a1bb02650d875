"""apps/sample.py of the port on the CPU at the tiny widths: the CLI builds
the avatar system from a config (tiny dual-branch prior from weight files,
a prompt cache filled with `dummy_encode_fn`, the SMPL-X stand-in), draws
the test view's skeleton, runs `sample_joint` and writes the image, the
depth and the pose side by side. The pose panel is held against the JAX
package's pose image of the same view, exactly (both draw the humansd
skeleton bit for bit); `sample_joint` itself is held against JAX in
tests/test_torch_guidance.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from humangaussian_torch.apps import sample
from humangaussian_torch.utils import saving
from port_parity_torch import tiny_port_guidance
from test_torch_loop import PROMPT, _tiny_avatar_config

torch.set_num_threads(1)


def test_sample_cli_end_to_end(tmp_path, capsys):
    from humangaussian_tpu.data.cameras import (
        RandomCameraConfig,
        eval_camera_batch,
    )
    from humangaussian_tpu.smplx.model import load_smplx_npz
    from humangaussian_tpu.smplx.skeleton import Skeleton
    from humangaussian_tpu.smplx.pose_image import draw_humansd_pose

    cfg = _tiny_avatar_config(tmp_path, tiny_port_guidance(seed=0))
    outs = []
    for seed in (0, 0, 1):
        out = str(tmp_path / f"sample{len(outs)}.png")
        assert sample.main(["--config", cfg, "--prompt", PROMPT,
                            "--steps", "3", "--seed", str(seed),
                            "--out", out, "--device", "cpu",
                            "system.pose_image_size=16"]) == out
        outs.append(np.asarray(Image.open(out)))
    assert f"wrote {out}" in capsys.readouterr().out
    grid = outs[0]
    assert grid.shape == (16, 3 * 16, 3)  # image, depth, pose at 16^2
    np.testing.assert_array_equal(outs[1], grid)  # the seed reproduces
    assert not np.array_equal(outs[2][:, :32], grid[:, :32])

    # the pose panel: the JAX package's skeleton image of the same view
    import yaml

    sys_cfg = yaml.safe_load(open(cfg))["system"]
    skel = Skeleton(style="humansd", apose=True).load_smplx(
        load_smplx_npz(sys_cfg["smplx_path"])).scale(-10)
    cams = eval_camera_batch(RandomCameraConfig(n_test_views=1), "test")
    img, _ = draw_humansd_pose(jnp.asarray(skel.points3d), cams.mvp_mtx[0],
                               16, 16, jnp.abs(cams.azimuth[0]) > 120.0)
    want = np.asarray(img)
    assert want.max() > 0
    np.testing.assert_array_equal(
        grid[:, 32:], saving.to_uint8(want))


def test_sample_cli_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        sample.main(["--config", str(tmp_path / "none.yaml"),
                     "--prompt", "a man"])
