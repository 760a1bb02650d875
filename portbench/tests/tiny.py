"""Tiny-width configurations of the benchmark's cells, for the CPU tests:
the same files with the widths, sizes and counts cut so that a run takes
seconds on the CPU (the program takes its kernels' plain versions there)."""
from __future__ import annotations

import copy
import io
import json
import os

from portbench import harness

BENCH = harness.load_json(harness.ROOT, "BENCHMARK.json")


def _file(*parts):
    return harness.load_json(harness.HERE, *parts)


def sd2():
    c = copy.deepcopy(_file("configs", "hg_avatar_sd2.json"))
    c["unet"].update({"block_out_channels": [32, 64], "layers_per_block": 1,
                      "cross_attention_dim": 32, "attn_heads": [2, 2],
                      "down_block_has_attn": [True, False],
                      "norm_num_groups": 8, "addition_time_embed_dim": 16,
                      "flash_attention": False, "dtype": "float32"})
    c["vae"].update({"block_out_channels": [32, 64], "layers_per_block": 1,
                     "norm_num_groups": 8, "dtype": "float32"})
    c["data"].update({"batch_size": 2, "height": 64, "width": 64,
                      "eval_height": 64, "eval_width": 64})
    c["system"].update({"capacity": 1024, "pts_num": 300,
                        "pose_image_size": 32, "tile_capacity": 256})
    c["system"]["guidance"].update({"image_size": 16, "latent_size": 8})
    c["prompt"] = {"seq": 7, "dim": 32}
    t = _file("workloads", "sd2_body.json")
    t.update(init_points=300, traced_units=1)
    return c, t


def anim():
    c = copy.deepcopy(_file("configs", "hg_avatar_anim.json"))
    c.update(n_gaussians=3000, size=64)
    t = _file("workloads", "anim_1024.json")
    t.update(check_frames=3, traced_units=2)
    return c, t


TINY = {"sd2_body": sd2, "anim_1024": anim}


def run(workload: str, seed: int = 2147483659, seconds: float = 1.0,
        trace: bool = False):
    """(exit code, last stdout line as a dict or None, stderr text) of a
    tiny run of `workload` on the CPU."""
    conf, traffic = TINY[workload]()
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run_cell(workload, seed, seconds, trace, device="cpu",
                          bench=BENCH, conf=conf, traffic=traffic, out=out,
                          err=err)
    lines = out.getvalue().strip().splitlines()
    return rc, json.loads(lines[-1]) if lines else None, err.getvalue()


if __name__ == "__main__":
    # the import check's child process: a tiny run, then the top-level
    # names of every loaded module
    import sys

    rc, res, _ = run(sys.argv[1])
    print(json.dumps({"rc": rc, "correct": res and res["correct"],
                      "modules": sorted({m.split(".")[0]
                                         for m in sys.modules})}))
    os._exit(0)
