"""The benchmark's two cells of SDXL base 1.0 and of the grown SD2 scene
on the CPU at tiny widths: each builds from its files, runs its window
and its traced window, reads its metrics and comes out `correct` against
the plain reference; the SDXL counts agree with the shapes worked by
hand.

    python -m pytest portbench/tests -q
"""
from __future__ import annotations

import copy
import io
import json

import pytest

from portbench import harness
from portbench.tests import tiny


def sdxl():
    c = copy.deepcopy(harness.load_json(harness.HERE, "configs",
                                        "hg_avatar_sdxl.json"))
    c["unet"].update({
        "block_out_channels": [32, 64, 64], "layers_per_block": 1,
        "cross_attention_dim": 48, "attn_heads": [2, 2, 2],
        "transformer_layers_per_block": [1, 1, 2], "pooled_text_dim": 24,
        "norm_num_groups": 8, "addition_time_embed_dim": 8,
        "flash_attention": False, "dtype": "float32"})
    c["vae"].update({"block_out_channels": [32, 64], "layers_per_block": 1,
                     "norm_num_groups": 8, "dtype": "float32"})
    c["data"].update({"batch_size": 2, "height": 64, "width": 64,
                      "eval_height": 64, "eval_width": 64})
    c["system"].update({"capacity": 1024, "pts_num": 300,
                        "pose_image_size": 32, "tile_capacity": 256})
    c["system"]["guidance"].update({"image_size": 64})
    c["prompt"] = {"seq": 7, "dim": 48, "pooled_dim": 24}
    t = harness.load_json(harness.HERE, "workloads", "sdxl_body.json")
    t.update(init_points=300, traced_units=1)
    return c, t


def sd2_grown():
    c, _ = tiny.sd2()
    t = harness.load_json(harness.HERE, "workloads", "sd2_grown.json")
    t.update(init_points=600, warm_steps=2, traced_units=1)
    return c, t


CELLS = {"sdxl_body": sdxl, "sd2_grown": sd2_grown}
TRACED = {"sdxl_body": {"mfu.sdxl", "unet_dev_ms.sdxl",
                        "xformer_dev_ms.sdxl", "encode_dev_ms.sdxl"},
          "sd2_grown": {"mfu.train", "render_dev_ms.train",
                        "render_idle_ms.train", "backward_dev_ms.train"}}


def run(workload, trace):
    conf, traffic = CELLS[workload]()
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run_cell(workload, 3_000_000_019, 0.5, trace, device="cpu",
                          bench=tiny.BENCH, conf=conf, traffic=traffic,
                          out=out, err=err)
    lines = out.getvalue().strip().splitlines()
    return rc, json.loads(lines[-1]) if lines else None, err.getvalue()


@pytest.mark.parametrize("workload", sorted(CELLS))
@pytest.mark.parametrize("trace", [False, True])
def test_new_cell_runs_and_is_correct(workload, trace):
    rc, res, err = run(workload, trace)
    assert rc == 0, err[-2000:]
    assert res["correct"], res["checks"]
    if trace:
        assert TRACED[workload] <= set(res["metrics"]), res["metrics"]
    else:
        assert {"step_ms", "peak_gib", "setup_s"} <= set(res["metrics"])


def test_sdxl_counts_at_full_width():
    """The SDXL cell's 70 K4 sites: 10 at (24, 4096, 10 heads, 64) and 60
    at (24, 1024, 20 heads, 64), 4 B H S^2 D FLOPs each; the step's model
    FLOPs are the UNet on 24 latents plus two encodes' worth."""
    from portbench.counts import attention_sdxl, prior_sdxl

    conf = harness.load_json(harness.HERE, "configs", "hg_avatar_sdxl.json")
    sites = attention_sdxl.sites(conf)
    assert sorted(set(sites)) == [(24, 1024, 20, 64), (24, 4096, 10, 64)]
    assert sites.count((24, 4096, 10, 64)) == 10
    assert sites.count((24, 1024, 20, 64)) == 60
    assert attention_sdxl.step_flops(conf) == (
        10 * 4 * 24 * 10 * 4096 ** 2 * 64 + 60 * 4 * 24 * 20 * 1024 ** 2 * 64)
    assert prior_sdxl.step_flops(conf) == (prior_sdxl.unet_flops(conf, 24)
                                           + 2 * prior_sdxl.encode_flops(
                                               conf, 8))
    assert 6.0e12 < prior_sdxl.unet_flops(conf, 1) < 7.5e12
