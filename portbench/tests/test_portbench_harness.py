"""The port's benchmark on the CPU: the harness finds its pieces by name,
prints the contract's last line, counts FLOPs and bytes as worked by hand,
runs each cell's path at tiny widths against the plain reference, sees
`correct` come out false under the faults a cell can have, and imports
neither JAX nor the JAX package (nor the program, from the reference).

    python -m pytest portbench/tests -q
"""
from __future__ import annotations

import ast
import json
import math
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "humangaussian_tpu"}


# ---- the pieces by name ----------------------------------------------------
def test_every_piece_is_found_by_name():
    b = tiny.BENCH
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    for c in b["configs"]:
        assert NAME.match(c["name"])
        assert os.path.isfile(os.path.join(harness.ROOT, c["file"]))
        mod = harness.load_module(
            os.path.join(harness.HERE, "configs", f"{c['name']}.py"), "m")
        assert callable(mod.build)
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert os.path.isfile(os.path.join(
            harness.HERE, "workloads", f"{w['traffic']}.json"))
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        reader = harness.load_module(
            os.path.join(harness.HERE, "metrics", f"{m['name']}.py"), "r")
        assert callable(reader.read)
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", []):
            e = next(x for x in b["end_to_end"] if x["name"] == m["moves"])
            assert harness.applies(e, cell)
    assert "setup_s" in e2e


def test_unknown_workload_prints_no_result():
    import io

    out, err = io.StringIO(), io.StringIO()
    assert harness.run_cell("no_such_cell", 1, 1.0, False, device="cpu",
                            out=out, err=err) != 0
    assert out.getvalue() == ""


def test_no_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card path is not reached")
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "anim_1024", "--seed", "3", "--seconds", "1",
                        "--trace", "0"], cwd=harness.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""


# ---- the last line ----------------------------------------------------------
@pytest.mark.parametrize("workload", ["sd2_body", "anim_1024"])
@pytest.mark.parametrize("trace", [False, True])
def test_last_line_keys(workload, trace):
    rc, res, err = tiny.run(workload, trace=trace)
    assert rc == 0, err
    keys = list(res)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert ("breakdown" in res) == trace
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    if trace:
        assert set(res["device"]) >= {"busy_s", "window_s"}
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in tiny.BENCH[kind]
             if harness.applies(m, workload)}
    assert set(res["metrics"]) <= names
    if not trace:
        assert "setup_s" in res["metrics"]
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    assert "limit" in err.strip().splitlines()[-1]


# ---- the counts ----------------------------------------------------------------
def _tiny_vae_conf(size):
    c, _ = tiny.sd2()
    c["vae"].update({"block_out_channels": [8], "layers_per_block": 1,
                     "norm_num_groups": 4})
    c["system"]["guidance"]["image_size"] = size
    return c


@pytest.mark.parametrize("size", [8, 16])
def test_encode_flops_by_hand(size):
    prior = harness.counts("prior")
    n = 3
    # conv_in 3->8 3x3; 7 convs 8->8 3x3 (down resnet 2, mid resnets 4,
    # conv_out); q, k, v, out 8x8 linear; quant_conv 8->8 1x1; QK^T and PV
    per_pixel = (2 * 3 * 8 * 9 + 7 * 2 * 8 * 8 * 9 + 4 * 2 * 8 * 8
                 + 2 * 8 * 8 + 2 * 2 * 8 * size * size)
    assert prior.encode_flops(_tiny_vae_conf(size), n) == \
        n * size * size * per_pixel


def test_step_flops_adds_unet_and_five_encodes():
    prior = harness.counts("prior")
    c, _ = tiny.sd2()
    b = c["data"]["batch_size"]
    assert prior.step_flops(c) == (prior.unet_flops(c, 3 * b)
                                   + 5 * prior.encode_flops(c, b))
    assert prior.unet_flops(c, 6) == 2 * prior.unet_flops(c, 3)


def test_groupnorm_calls_and_bytes():
    gn = harness.counts("groupnorm")
    c = _tiny_vae_conf(16)
    c["vae"]["dtype"] = "bfloat16"
    calls = gn.step_calls(c)
    b = c["data"]["batch_size"]
    vae = [s for s in calls if s[0] == b and s[2] == 16]
    # per encode: down resnet 2, mid resnets 4, attention 1, norm_out 1
    assert len(vae) == 5 * 8
    assert all(s == (b, 8, 16, 16) for s in vae)
    unet = calls[:len(calls) - len(vae)]
    assert all(s[0] == 3 * b for s in unet)
    want = (sum(2 * math.prod(s) * 4 for s in unet)
            + sum(2 * math.prod(s) * 2 for s in vae))
    assert gn.fwd_bytes(c) == want


def test_groupnorm_calls_at_full_width():
    gn = harness.counts("groupnorm")
    c = harness.load_json(harness.HERE, "configs", "hg_avatar_sd2.json")
    calls = gn.step_calls(c)
    assert len(calls) == 77 + 5 * 22  # the launches a train_step counts
    assert calls[0] == (24, 320, 64, 64)


def test_raster_work_of_one_splat_by_hand():
    from portbench.reference.camera import camera_from_c2w, look_at_c2w
    from portbench.reference.projection import RasterizeConfig

    raster = harness.counts("raster")
    eye = torch.tensor([0.0, 0.0, 2.0])
    c2w = look_at_c2w(eye, torch.zeros(3), torch.tensor([0.0, 1.0, 0.0]))
    cam = camera_from_c2w(c2w, 0.9, 32, 32)
    params = {"means": torch.zeros(1, 3),
              "log_scales": torch.full((1, 3), math.log(0.1)),
              "quats": torch.tensor([[1.0, 0.0, 0.0, 0.0]]),
              "sh_dc": torch.zeros(1, 3), "sh_rest": torch.zeros(1, 0, 3),
              "opacity_logits": torch.zeros(1, 1)}
    w = raster.work(params, torch.ones(1, dtype=torch.bool), [cam], 64,
                    RasterizeConfig(), torch.zeros(3), True)
    # an isotropic splat at the image centre (15.5, 15.5): alpha = 0.5
    # exp(-r^2 / 2 var) over the integer pixel centres, var = (f 0.1 / 2)^2
    # pixels^2 + 0.3 (the projection's low-pass dilation)
    f = 16.0 / math.tan(0.45)
    var = (f * 0.1 / 2.0) ** 2 + 0.3
    ys, xs = np.mgrid[0:32, 0:32]
    r2 = (xs - 15.5) ** 2 + (ys - 15.5) ** 2
    alpha = 0.5 * np.exp(-0.5 * r2 / var)
    contribs = int((alpha >= 1 / 255).sum())
    assert w["visible"] == 1 and w["pairs"] == 1
    assert w["contribs"] == contribs
    assert w["fwd_bytes"] == 40 + 4 + 32 * 32 * 28
    assert w["bwd_bytes"] == 2 * 40 + 4 + 32 * 32 * 28
    assert w["fwd_flops"] == w["contribs"] * raster.FWD_FLOPS
    assert w["bwd_flops"] == w["contribs"] * raster.BWD_FLOPS


# ---- each cell's path against the reference, and its faults ------------------
@pytest.mark.parametrize("workload", ["sd2_body", "anim_1024"])
def test_tiny_cell_matches_the_reference(workload):
    rc, res, err = tiny.run(workload, seconds=2.0)
    assert rc == 0, err
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0


@pytest.mark.parametrize("workload,fault", [
    ("sd2_body", "state_unchanged"), ("sd2_body", "half_batch"),
    ("anim_1024", "answer_altered")])
def test_a_broken_timed_path_reads_incorrect(workload, fault):
    from portbench.faults import planted

    with planted(fault):
        rc, res, err = tiny.run(workload)
    assert rc == 0, err
    assert res["correct"] is False, res["checks"]
    assert res["failed"] > 0


@pytest.mark.parametrize("workload", ["sd2_body", "anim_1024"])
def test_control_reads_above_the_program(workload):
    """The control (the reference in the precision below the
    configuration's, in the program's place) reads higher than the program
    on every compared number that the control moves."""
    import io

    from portbench.calibrate import calibrate

    conf, traffic = tiny.TINY[workload]()
    rows = []
    for control in (False, True):
        out = io.StringIO()
        calibrate(workload, [2147483701], 1.0, control, device="cpu",
                  bench=tiny.BENCH, conf=conf, traffic=traffic, out=out)
        rows.append(json.loads(out.getvalue().strip().splitlines()[-1]))
    prog, ctrl = rows
    moved = [k for k in prog if isinstance(prog[k], float)
             and ctrl[k] > 10 * prog[k] + 1e-12]
    assert moved, (prog, ctrl)


# ---- imports ---------------------------------------------------------------------
@pytest.mark.parametrize("workload", ["sd2_body", "anim_1024"])
def test_a_run_imports_no_jax(workload):
    env = dict(os.environ, PYTHONPATH=harness.ROOT, OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-m", "portbench.tests.tiny",
                        workload], cwd=harness.ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["rc"] == 0 and res["correct"]
    assert not FORBIDDEN & set(res["modules"])
    assert "humangaussian_torch" in res["modules"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(harness.HERE, "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            tops = {m.split(".")[0] for m in _imports(os.path.join(ref,
                                                                  name))}
            assert not tops & (FORBIDDEN | {"humangaussian_torch"}), name


# ---- on the card -------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the cells run the CUDA kernels)")


@pytest.mark.cuda
def test_anim_cell_on_the_card(card):
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "anim_1024", "--seed", "2147483711", "--seconds",
                        "2", "--trace", "0"], cwd=harness.ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout.strip().splitlines()[-1])["correct"]
