"""The avatar trainer against SDXL base 1.0 through the normal path, at
the published widths, on the card: seeded bfloat16 weight files in
diffusers layout (`unet/`, `vae/`, 5.1 GB and 0.17 GB), the procedural
SMPL-X stand-in and a prompt cache of `dummy_encode_fn(77, 2048,
pooled_dim=1280)` stand-ins (the card has no text encoder) are written
under `build/sdxl_launch/`, then `apps.launch.main` trains from the
shipped configs/avatar_sdxl.yaml for `--steps` steps and writes its
artifacts. Prints the ms a step the launcher's loop logged, the peak
memory and the artifacts.

    python3 scripts/sdxl_launch_check.py --steps 6
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def write_files(tmp: str, dev) -> list:
    """The weight files, the SMPL-X stand-in and the prompt cache; the
    overrides of configs/avatar_sdxl.yaml that point at them."""
    from chip_smoke import write_assets, write_sdxl_files

    smplx_path = write_assets(tmp, n_avatar=1000)[0]
    return [f"system.smplx_path={smplx_path}",
            *write_sdxl_files(dev, tmp),
            f"exp_root_dir={os.path.join(tmp, 'outputs')}"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=6)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 3
    from humangaussian_torch.apps import launch

    dev = torch.device("cuda")
    tmp = os.path.join(ROOT, "build", "sdxl_launch")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    t0 = time.perf_counter()
    overrides = write_files(tmp, dev)
    print(f"files written in {time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trial = launch.main([
        "--config", os.path.join(ROOT, "configs", "avatar_sdxl.yaml"),
        "--train", *overrides, f"trainer.max_steps={args.steps}",
        f"trainer.val_check_interval={args.steps}", "trainer.log_every=1"])
    print(f"launch.main: {time.perf_counter() - t0:.1f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"({torch.cuda.get_device_name()}); artifacts "
          f"{sorted(os.listdir(os.path.join(trial, 'save')))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
