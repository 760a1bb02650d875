"""SDXL base 1.0 as the avatar trainer's prior, on the CPU at tiny widths:
the UNet's per-level transformer depth and text-time embedding against the
benchmark's plain reference (`portbench/reference/unet_sdxl.py`), the
full-width parameter count, the other priors' parameter names unchanged,
the VAE's query-chunked attention against its one-pass form, the pooled
prompt rows, the launcher's `stable-diffusion-xl` path from
configs/avatar_sdxl.yaml, the benchmark's SDXL cell against the plain
trainer and under the half-batch fault, and the tile-capacity ladder
across one-step calls."""
import copy
import dataclasses
import hashlib
import io
import json
import os

import numpy as np
import pytest
import torch
import yaml

from humangaussian_torch.apps import launch
from humangaussian_torch.guidance import controlnet, deep_floyd
from humangaussian_torch.guidance import prompt as port_prompt
from humangaussian_torch.guidance import unet as port_unet
from humangaussian_torch.guidance import vae as port_vae
from humangaussian_torch.guidance.stable_diffusion_xl import (
    TINY_SDXL_CONFIG,
    SDXLSystemGuidance,
)
from humangaussian_torch.train import checkpoint, loop
from port_parity_torch import tiny_port_system
from test_launch import make_smplx_npz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny_ref_config():
    from portbench.reference.unet_sdxl import SDXLUNetConfig

    t = TINY_SDXL_CONFIG
    return SDXLUNetConfig(
        block_out_channels=t.block_out_channels,
        layers_per_block=t.layers_per_block,
        cross_attention_dim=t.cross_attention_dim, attn_heads=t.attn_heads,
        down_block_has_attn=t.down_block_has_attn,
        transformer_layers_per_block=t.transformer_layers_per_block,
        pooled_text_dim=t.pooled_text_dim,
        addition_time_embed_dim=t.addition_time_embed_dim,
        norm_num_groups=t.norm_num_groups)


def _seeded(module, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return module


@pytest.mark.parametrize("seed", [0, 1])
def test_tiny_sdxl_unet_matches_the_plain_reference(seed):
    """A 3-level SDXL-shaped UNet (no attention at level 0, stacks 1 and 2
    deep, text-time conditioning on pooled rows) on seeded weights: the
    port's SingleUNet and the plain reference share every parameter name
    and agree to float32 round-off; the pooled rows and the time ids move
    the output."""
    from portbench.reference.unet_sdxl import SDXLUNet

    torch.manual_seed(seed)
    port = _seeded(port_unet.SingleUNet(TINY_SDXL_CONFIG), seed)
    ref = SDXLUNet(_tiny_ref_config())
    assert set(port.state_dict()) == set(ref.state_dict())
    ref.load_state_dict(port.state_dict())
    gen = torch.Generator().manual_seed(seed + 10)
    x = torch.randn((2, 16, 16, 4), generator=gen)
    t = torch.tensor([17, 640])
    text = torch.randn((2, 7, 48), generator=gen)
    pooled = torch.randn((2, 24), generator=gen)
    ids = torch.tensor([[64.0, 64, 0, 0, 64, 64], [32.0, 48, 8, 0, 64, 64]])
    with torch.no_grad():
        got = port(x, t, text, text_embeds=pooled, time_ids=ids)
        want = ref(x, t, text, pooled, ids)
        moved = port(x, t, text, text_embeds=pooled.flip(0), time_ids=ids)
    assert got.shape == (2, 16, 16, 4)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    assert (moved - got).abs().max() > 1e-3


def test_full_width_sdxl_parameter_count_and_depth():
    """SDXL base 1.0's published UNet: 2,567,463,684 parameters, 70
    transformer blocks in 11 stacks (2 + 2 down, 1 mid, 3 + 3 up; 2 deep
    at 640 channels, 10 at 1280), the text-time MLP 2816 -> 1280 ->
    1280."""
    with torch.device("meta"):
        unet = port_unet.SingleUNet(port_unet.SDXL_BASE_CONFIG)
    assert sum(p.numel() for p in unet.parameters()) == 2_567_463_684
    stacks = [m for m in unet.modules()
              if isinstance(m, port_unet.Transformer2DModel)]
    assert sorted(len(s.transformer_blocks) for s in stacks) == \
        [2] * 5 + [10] * 6
    assert sum(len(s.transformer_blocks) for s in stacks) == 70
    assert unet.add_embedding.linear_1.weight.shape == (1280, 2816)
    assert unet.add_embedding.linear_2.weight.shape == (1280, 1280)
    assert unet.down_blocks[0].attentions is None
    assert [len(a.transformer_blocks) for a in
            unet.mid_block.attentions] == [10]


def _key_hash(module):
    sd = module.state_dict()
    text = "\n".join(f"{k} {tuple(v.shape)}" for k, v in sorted(sd.items()))
    return (hashlib.sha256(text.encode()).hexdigest()[:16], len(sd),
            sum(v.numel() for v in sd.values()))


@pytest.mark.parametrize("name,build,want", [
    ("sd2_dual", lambda: port_unet.DualBranchUNet(port_unet.SD2_BASE_CONFIG),
     ("bbfc89d0ebf67553", 884, 899_719_048)),
    ("sd2_single", lambda: port_unet.SingleUNet(port_unet.SD2_SINGLE_CONFIG),
     ("61d626becb5b11d8", 686, 865_910_724)),
    ("if_xl", lambda: port_unet.SingleUNet(deep_floyd.IF_I_XL_CONFIG),
     ("7dce18a1852f8528", 1114, 6_831_512_518)),
    ("sd15", lambda: controlnet.UNet2D(),
     ("5159ace1d6e60acb", 686, 859_520_964)),
    ("controlnet", lambda: controlnet.ControlNet(),
     ("405e1981f291b84c", 340, 361_279_120)),
    ("vae", lambda: port_vae.AutoencoderKL(port_vae.VAEConfig()),
     ("600696bc94ffc80f", 248, 83_653_863)),
])
def test_other_priors_keep_their_parameter_names(name, build, want):
    """The transformer depth and the text-time embedding default to what
    every earlier configuration builds: the SD2 (joint and single), IF,
    SD 1.5, ControlNet and VAE state dicts keep their names, shapes and
    counts (the hashes of the sorted name-and-shape lists as built before
    the SDXL fields existed)."""
    with torch.device("meta"):
        got = _key_hash(build())
    assert got == want, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_vae_attention_matches_one_pass(dtype, monkeypatch):
    """The mid block's attention with a cap so small that the queries run
    in chunks of 6 rows: the output and the input's gradient equal the
    one-pass form's (float32: to round-off; bfloat16: within a few ulps),
    and the chunks are checkpointed (the backward recomputes them)."""
    torch.manual_seed(0)
    blk = port_vae.AttnBlock(16, 4).to(dtype).requires_grad_(False)
    x0 = torch.randn((2, 16, 5, 8)).to(dtype)
    cot = torch.randn((2, 16, 5, 8)).to(dtype)

    def run():
        x = x0.clone().requires_grad_(True)
        y = blk(x)
        (y.float() * cot.float()).sum().backward()
        return y.detach(), x.grad

    one = run()
    calls = []
    own = port_vae.chunked_attention

    def spy(q, k, v, rows):
        calls.append(rows)
        return own(q, k, v, rows)

    monkeypatch.setattr(port_vae, "chunked_attention", spy)
    monkeypatch.setattr(port_vae, "ATTN_CAP_BYTES", 2 * 40 * 4 * 6)
    assert port_vae.attention_chunk_rows(2, 40) == 6
    chunked = run()
    assert calls == [6]
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == torch.float32 else \
        dict(rtol=2e-2, atol=2e-2)
    for a, b in zip(chunked, one):
        torch.testing.assert_close(a.float(), b.float(), **tol)


def test_vae_attention_takes_one_pass_at_sd2_size():
    """At the SD2 cell's encode (batch 8, 64^2 = 4096 tokens) the logits
    fit the cap and the one-pass form runs; at SDXL's (128^2 = 16,384
    tokens) they take 8 GiB and run in chunks of 2048 queries."""
    assert port_vae.attention_chunk_rows(8, 4096) >= 4096
    assert port_vae.attention_chunk_rows(8, 16384) == 2048
    assert port_vae.SDXL_VAE_CONFIG.scaling_factor == 0.13025
    assert port_vae.VAEConfig().scaling_factor == 0.18215


def test_pooled_rows_follow_the_token_rows(tmp_path):
    """`encoder_type: sdxl` caches the pooled rows beside the token rows;
    the pooled rows' `get_text_embeddings` picks each camera's direction as
    the token rows' does; a second processor reads both from the cache
    with no encoder."""
    cfg = port_prompt.PromptProcessorConfig(
        prompt="a man", negative_prompt="blurry", model_path="sdxl-stand-in",
        cache_dir=str(tmp_path), encoder_type="sdxl")
    emb = port_prompt.PromptProcessor(
        cfg, port_prompt.dummy_encode_fn(7, 48, pooled_dim=24),
        device="cpu")()
    assert emb.text_vd.shape == (4, 7, 48) and emb.pooled.text_vd.shape == \
        (4, 24)
    el = torch.tensor([10.0, 0.0, 0.0, 70.0])
    az = torch.tensor([0.0, 90.0, 180.0, 0.0])
    text = emb.get_text_embeddings(el, az)
    pooled = emb.pooled.get_text_embeddings(el, az)
    assert pooled.shape == (12, 24)
    for i in range(12):
        j = [k for k in range(4) if torch.equal(text[i], emb.text_vd[k])]
        if j:
            assert torch.equal(pooled[i], emb.pooled.text_vd[j[0]])
    assert torch.equal(pooled[8:], emb.pooled.null.expand(4, 24))
    again = port_prompt.PromptProcessor(cfg, lambda p: 1 / 0,
                                        device="cpu")()
    for name in ("text_vd", "uncond_vd", "text", "uncond", "null"):
        assert torch.equal(getattr(again.pooled, name),
                           getattr(emb.pooled, name))
    with pytest.raises(ValueError, match="pooled"):
        port_prompt.PromptProcessor(
            dataclasses.replace(cfg, cache_dir=str(tmp_path / "b")),
            port_prompt.dummy_encode_fn(7, 48), device="cpu")()


def _sdxl_yaml(tmp_path):
    """configs/avatar_sdxl.yaml at tiny widths: the tiny SDXL UNet and VAE
    written in diffusers' names under `model/unet/` and `model/vae/`,
    the SMPL-X stand-in, a prompt cache of 7 x 48 token rows and 24-wide
    pooled rows."""
    torch.manual_seed(5)
    unet = _seeded(port_unet.SingleUNet(TINY_SDXL_CONFIG), 5)
    vae = port_vae.AutoencoderKL(port_vae.tiny_vae_config())
    for sub, m in (("unet", unet), ("vae", vae)):
        (tmp_path / "model" / sub).mkdir(parents=True)
        torch.save(m.state_dict(), tmp_path / "model" / sub
                   / "diffusion_pytorch_model.bin")
    smplx_path = str(tmp_path / "SMPLX_NEUTRAL.npz")
    make_smplx_npz(smplx_path)
    cache = str(tmp_path / "text_embeddings")
    port_prompt.PromptProcessor(
        port_prompt.PromptProcessorConfig(
            prompt="a man", negative_prompt="blurry",
            model_path="sdxl-stand-in", cache_dir=cache,
            encoder_type="sdxl"),
        port_prompt.dummy_encode_fn(7, 48, pooled_dim=24), device="cpu")()
    with open(os.path.join(REPO, "configs", "avatar_sdxl.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg.update(seed=0, exp_root_dir=str(tmp_path / "out"))
    cfg["data"].update(batch_size=2, height=64, width=64, eval_height=64,
                       eval_width=64, n_val_views=2, n_test_views=2)
    s = cfg["system"]
    s.update(smplx_path=smplx_path, capacity=1024, pts_num=300,
             pose_image_size=64, tile_capacity=1024)
    s["prompt_processor"].update(
        prompt="a man", negative_prompt="blurry",
        pretrained_model_name_or_path="sdxl-stand-in", cache_dir=cache)
    s["guidance"].update(arch="tiny", model_key=str(tmp_path / "model"),
                         vae_key="", image_size=64)
    cfg["trainer"] = {"max_steps": 2, "val_check_interval": 2,
                      "log_every": 1}
    path = tmp_path / "avatar_sdxl.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path), cfg, unet


def test_launch_trains_an_avatar_against_sdxl(tmp_path):
    """The shipped configs/avatar_sdxl.yaml through `apps.launch` at tiny
    widths: `build_sdxl_guidance` loads `unet/` and `vae/` in diffusers'
    names with no converter (weights rounded through bfloat16), the
    prompt processor defaults to the `sdxl` encoder type and hands the
    pooled rows on, a step's metrics are finite, and the CLI trains two
    steps and writes the artifacts."""
    path, cfg, unet = _sdxl_yaml(tmp_path)
    system = launch.build_system(cfg, "cpu")
    g = system.guidance
    assert isinstance(g, SDXLSystemGuidance)
    assert g.xl.cfg.mode == "anpg" and g.xl.cfg.guidance_scale == 7.5
    assert g.xl.vae.cfg.scaling_factor == 0.13025
    assert g.schedule.prediction_type == "epsilon"
    assert system.prompt_embeddings.pooled.text_vd.shape == (4, 24)
    torch.testing.assert_close(
        g.xl.unet.add_embedding.linear_1.weight,
        unet.add_embedding.linear_1.weight.to(torch.bfloat16).float(),
        rtol=0, atol=0)
    state = system.init_state(seed=0)
    inputs = system.sample_step_inputs(state)
    assert inputs.pooled.shape == (6, 24)
    state, metrics = system.train_step(state, inputs)
    assert all(bool(torch.isfinite(v).all()) for v in metrics.values())
    assert float(metrics["grad_norm"]) > 0
    trial = launch.main(["--config", path, "--train", "--device", "cpu"])
    save = os.path.join(trial, "save")
    assert {"last.ply", "metrics.csv"} <= set(os.listdir(save))


def test_build_sdxl_guidance_rejects_an_unknown_arch(tmp_path):
    _path, cfg, _ = _sdxl_yaml(tmp_path)
    cfg["system"]["guidance"]["arch"] = "sdxl-refiner"
    with pytest.raises(ValueError, match="stable-diffusion-xl arch"):
        launch.build_sdxl_guidance(cfg, "cpu")


def _tiny_sdxl_cell():
    from portbench import harness

    c = copy.deepcopy(harness.load_json(harness.HERE, "configs",
                                        "hg_avatar_sdxl.json"))
    t = TINY_SDXL_CONFIG
    c["unet"].update({
        "block_out_channels": list(t.block_out_channels),
        "layers_per_block": 1, "cross_attention_dim": 48,
        "attn_heads": list(t.attn_heads),
        "transformer_layers_per_block": list(t.transformer_layers_per_block),
        "pooled_text_dim": 24, "norm_num_groups": 8,
        "addition_time_embed_dim": 8, "flash_attention": False,
        "dtype": "float32"})
    c["vae"].update({"block_out_channels": [32, 64], "layers_per_block": 1,
                     "norm_num_groups": 8, "dtype": "float32"})
    c["data"].update({"batch_size": 2, "height": 64, "width": 64,
                      "eval_height": 64, "eval_width": 64})
    c["system"].update({"capacity": 1024, "pts_num": 300,
                        "pose_image_size": 32, "tile_capacity": 256})
    c["system"]["guidance"].update({"image_size": 64})
    c["prompt"] = {"seq": 7, "dim": 48, "pooled_dim": 24}
    traffic = harness.load_json(harness.HERE, "workloads", "sdxl_body.json")
    traffic.update(init_points=300, traced_units=1)
    return c, traffic


CELL_CHILD = """
import io, json, sys
from portbench import harness
conf, traffic, trace = json.load(open(sys.argv[1]))
out, err = io.StringIO(), io.StringIO()
rc = harness.run_cell("sdxl_body", 2718281829, 0.5, trace, device="cpu",
                      conf=conf, traffic=traffic, out=out, err=err)
print(json.dumps({"rc": rc, "out": out.getvalue(), "err": err.getvalue()}))
"""


@pytest.mark.parametrize("trace", [False, True])
def test_sdxl_cell_matches_the_plain_trainer(tmp_path, trace):
    """The benchmark's sdxl_body cell at tiny widths on the CPU, in a
    process of its own (the harness refuses to run beside JAX): three
    `train_step`s with the SDXL adapter against the plain float32 trainer
    (`portbench/reference/avatar_sdxl.py`) agree far inside the cell's
    limits, the launch note counts the transformer blocks, and the traced
    run reads the new SDXL metrics from the spans."""
    import subprocess
    import sys

    conf, traffic = _tiny_sdxl_cell()
    args = tmp_path / "cell.json"
    args.write_text(json.dumps([conf, traffic, trace]))
    r = subprocess.run([sys.executable, "-c", CELL_CHILD, str(args)],
                       cwd=REPO, capture_output=True, text=True,
                       timeout=600, env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert r.returncode == 0, r.stderr[-2000:]
    child = json.loads(r.stdout.strip().splitlines()[-1])
    assert child["rc"] == 0, child["err"][-2000:]
    res = json.loads(child["out"].strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    for name, c in res["checks"].items():
        assert c["value"] < 1e-3, (name, c)
    assert "transformer blocks run" in child["err"]
    if trace:
        assert {"mfu.sdxl", "unet_dev_ms.sdxl", "xformer_dev_ms.sdxl",
                "encode_dev_ms.sdxl"} <= set(res["metrics"])
    else:
        assert {"step_ms", "peak_gib", "setup_s"} <= set(res["metrics"])


FAULT_CHILD = """
import io, json, os, sys
sys.path.insert(0, "scripts")
from portbench import harness
from portbench.calibrate import calibrate
from sdxl_half_batch import pooled_rows_halved
conf, traffic = json.load(open(sys.argv[1]))
out = io.StringIO()
with pooled_rows_halved():
    calibrate("sdxl_body", [2718281829], 0.0, control=False, device="cpu",
              conf=conf, traffic=traffic, out=out, fault="half_batch")
cell = harness.load_module(os.path.join(harness.HERE, "configs",
                                        "hg_avatar_sdxl.py"), "cell")
print(json.dumps([json.loads(out.getvalue().strip().splitlines()[-1]),
                  cell.LIMITS]))
"""


def test_sdxl_cell_fails_under_the_half_batch_fault(tmp_path):
    """The half-batch fault (the step's loss and gradients from half the
    camera batch, the pooled rows halved with the token rows by
    scripts/sdxl_half_batch.py) on the tiny SDXL cell: the loss, the
    gradients' norm and their difference each read past the cell's
    limit, as on the card."""
    import subprocess
    import sys

    args = tmp_path / "cell.json"
    args.write_text(json.dumps(list(_tiny_sdxl_cell())))
    r = subprocess.run([sys.executable, "-c", FAULT_CHILD, str(args)],
                       cwd=REPO, capture_output=True, text=True,
                       timeout=600, env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert r.returncode == 0, r.stderr[-2000:]
    row, limits = json.loads(r.stdout.strip().splitlines()[-1])
    assert row["fault"] == "half_batch"
    for name in ("loss_rel_gap", "grad_norm_gap", "grad_rel_diff"):
        assert row[name] > limits[name], (name, row[name], limits[name])


def test_tile_ladder_climbs_across_one_step_calls(tmp_path, monkeypatch):
    """A scene that overflows a tiny tile capacity every step: nine
    one-step `run_training` calls climb the ladder as one nine-step call
    does (the overflow streak rides in the TrainState), and the
    checkpoint keeps the streak."""
    monkeypatch.setattr(loop, "OVERFLOW_GROW_THRESHOLD", 0)
    quiet = dict(val_interval=0, save_dir=None, log_every=1,
                 log_fn=lambda *_a: None)
    caps = []
    for one_step in (False, True):
        system = tiny_port_system(seed=0, tile_capacity=16,
                                  densify_prune_start_step=100)
        state = system.init_state(seed=0)
        if one_step:
            for _ in range(9):
                state, _h = loop.run_training(system, state,
                                              max_steps=state.step + 1,
                                              **quiet)
        else:
            state, _h = loop.run_training(system, state, max_steps=9,
                                          **quiet)
        caps.append((state.tile_cap, state.ovf_streak))
    assert caps[0] == caps[1]
    assert caps[0][0] == 384  # 16 -> 128 -> 256 -> 384 at steps 3, 6, 9
    state = state._replace(ovf_streak=2)
    path = checkpoint.save_checkpoint(str(tmp_path / "ckpt"), state)
    back = checkpoint.restore_checkpoint(path, system.init_state(seed=1))
    assert (back.tile_cap, back.ovf_streak) == (384, 2)
    np.testing.assert_array_equal(back.scene.means.numpy(),
                                  state.scene.means.numpy())
