"""PyTorch port vs JAX: the avatar trainer's loop, checkpoints, loggers,
prompt encoder and launcher.

- `hf_clip_encode_fn` on a tiny random `CLIPTextModel` built from a config
  (nothing downloaded) equals the JAX package's output exactly: both run
  the text model in torch on the host.
- The CLI end to end on the CPU: `apps.launch.main` on a tiny avatar
  config (`tests/test_launch.py::make_smplx_npz`, tiny weight files, a
  prompt cache filled with `dummy_encode_fn`, so no encoder is built)
  writes `last.ply`, the orbit video, `it*-val.png`, `metrics.csv` and
  `ckpts/last`; the JAX `load_ply` reads that `last.ply` with the port's
  means; `--resume` continues from the saved step and takes exactly the
  missing steps.
- `run_training` logs, validates and runs density control on the host
  step's schedule, and grows the per-tile pair cap when the render drops
  more than the threshold of pairs on consecutive logged checks; the
  loggers and the saving helpers write what they
  should.
"""
import csv
import json
import os
import re
from typing import NamedTuple

import numpy as np
import pytest
import torch
import yaml

from humangaussian_torch.apps import launch
from humangaussian_torch.guidance import prompt as port_prompt
from humangaussian_torch.io.ply import load_ply as port_load_ply
from humangaussian_torch.train.loop import (
    OVERFLOW_GROW_THRESHOLD,
    OVERFLOW_PATIENCE,
    TILE_CAP_MAX,
    grown_tile_cap,
    run_training,
    snapshot_code,
)
from humangaussian_torch.utils import loggers, saving
from humangaussian_tpu.guidance import prompt as jax_prompt
from humangaussian_tpu.io.ply import load_ply as jax_load_ply
from port_parity_torch import tiny_port_guidance
from test_launch import make_smplx_npz

torch.set_num_threads(1)
PROMPT = "a tiny avatar"


def _write_clip(root):
    """A tiny random CLIP text model and a character-level tokenizer."""
    from transformers import CLIPTextConfig, CLIPTextModel, CLIPTokenizer

    letters = "abcdefghijklmnopqrstuvwxyz"
    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1}
    for c in letters + ",":
        vocab[c] = len(vocab)
        vocab[c + "</w>"] = len(vocab)
    tok_dir = root / "tokenizer"
    tok_dir.mkdir(parents=True)
    (tok_dir / "vocab.json").write_text(json.dumps(vocab))
    (tok_dir / "merges.txt").write_text("#version: 0.2\n")
    CLIPTokenizer(str(tok_dir / "vocab.json"), str(tok_dir / "merges.txt"),
                  pad_token="<|endoftext|>").save_pretrained(str(tok_dir))
    torch.manual_seed(0)
    cfg = CLIPTextConfig(vocab_size=len(vocab), hidden_size=32,
                         intermediate_size=64, num_hidden_layers=2,
                         num_attention_heads=2, max_position_embeddings=77,
                         bos_token_id=0, eos_token_id=1, pad_token_id=1)
    CLIPTextModel(cfg).save_pretrained(str(root / "text_encoder"))
    return str(root)


def test_hf_clip_encode_fn_matches(tmp_path):
    pytest.importorskip("transformers")
    path = _write_clip(tmp_path / "clip")
    prompts = ["a man, side view", "blurry", ""]
    got = port_prompt.hf_clip_encode_fn(path)(prompts)
    want = jax_prompt.hf_clip_encode_fn(path)(prompts)
    assert got.shape == (3, 77, 32) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # the processor builds it on a cache miss when no encode_fn is given
    cfg = port_prompt.PromptProcessorConfig(
        prompt="a man", negative_prompt="blurry", model_path=path,
        cache_dir=str(tmp_path / "cache"))
    emb = port_prompt.PromptProcessor(cfg, device="cpu")()
    np.testing.assert_array_equal(emb.uncond.numpy(), want[1])


def _tiny_avatar_config(tmp_path, pg):
    (tmp_path / "joint" / "unet_ema").mkdir(parents=True)
    (tmp_path / "vae").mkdir()
    torch.save(pg.unet.state_dict(), tmp_path / "joint" / "unet_ema"
               / "diffusion_pytorch_model.bin")
    torch.save(pg.vae.state_dict(),
               tmp_path / "vae" / "diffusion_pytorch_model.bin")
    smplx_path = str(tmp_path / "SMPLX_NEUTRAL.npz")
    make_smplx_npz(smplx_path)
    cache = str(tmp_path / "text_embeddings")
    pp = {"prompt": "???", "negative_prompt": "blurry",
          "pretrained_model_name_or_path": "clip-stand-in",
          "cache_dir": cache}
    # fill the processor's cache so that the run builds no text encoder
    port_prompt.PromptProcessor(
        port_prompt.PromptProcessorConfig(
            prompt=PROMPT, negative_prompt="blurry",
            model_path="clip-stand-in", cache_dir=cache),
        port_prompt.dummy_encode_fn(7, 32), device="cpu")()
    cfg = {
        "name": "tiny", "seed": 0,
        "tag": "${rmspace:${system.prompt_processor.prompt},_}",
        "exp_root_dir": str(tmp_path / "out"),
        "data": {"batch_size": 2, "height": 64, "width": 64,
                 "eval_height": 64, "eval_width": 64, "n_val_views": 2,
                 "n_test_views": 3},
        "system": {
            "smplx_path": smplx_path, "capacity": 1024, "pts_num": 300,
            "pose_image_size": 64, "tile_capacity": 1024,
            "rasterizer": {"tile": 32, "max_tiles_per_gaussian": 4},
            "densify_prune_start_step": 1, "densify_prune_interval": 2,
            "densify_prune_end_step": 3, "max_grad": 1.0e-6,
            "prompt_processor": pp,
            "guidance": {"arch": "tiny", "model_key": str(tmp_path / "joint"),
                         "vae_key": str(tmp_path / "vae"),
                         "guidance_scale": 7.5},
        },
        "trainer": {"max_steps": 3, "val_check_interval": 2,
                    "log_every": 1},
    }
    path = tmp_path / "avatar.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _metrics(save):
    with open(os.path.join(save, "metrics.csv")) as f:
        return list(csv.DictReader(f))


def test_avatar_cli_end_to_end_and_resume(tmp_path, capsys):
    cfg = _tiny_avatar_config(tmp_path, tiny_port_guidance(seed=0))
    trial = launch.main(["--config", cfg, "--train", "--device", "cpu",
                         f"system.prompt_processor.prompt={PROMPT}"])
    assert os.path.basename(trial).startswith("a_tiny_avatar@")
    save = os.path.join(trial, "save")
    out = capsys.readouterr().out
    assert f"artifacts in {save}" in out
    files = set(os.listdir(save))
    assert {"last.ply", "metrics.csv", "it2-val.png"} <= files
    assert any(f.startswith("orbit.") for f in files)
    assert os.path.exists(os.path.join(save, "ckpts", "last", "state.pt"))
    assert os.path.exists(os.path.join(trial, "csv_logs", "metrics.csv"))
    rows = _metrics(save)
    assert [int(r["step"]) for r in rows] == [1, 2, 3]
    assert int(rows[1]["n_cloned"]) + int(rows[1]["n_split"]) > 0  # step 2
    for key in ("loss", "loss_sds", "loss_sparsity", "loss_opaque",
                "grad_norm", "overflow", "overflow_spill", "n_alive"):
        assert np.isfinite(float(rows[-1][key])), key

    got = port_load_ply(os.path.join(save, "last.ply"), device="cpu")
    want = jax_load_ply(os.path.join(save, "last.ply"))
    alive = np.asarray(want.alive)
    np.testing.assert_array_equal(got.alive.numpy(), alive)
    np.testing.assert_array_equal(got.means.numpy()[alive],
                                  np.asarray(want.means)[alive])
    assert int(alive.sum()) > 300  # the density-control pass cloned

    launch.main(["--config", cfg, "--train", "--device", "cpu",
                 "--resume", os.path.join(save, "ckpts", "last"),
                 f"system.prompt_processor.prompt={PROMPT}",
                 "trainer.max_steps=4"])
    out = capsys.readouterr().out
    assert re.search(r"resumed from .* at step 3", out)
    trials = sorted(os.listdir(os.path.dirname(trial)))
    assert len(trials) == 2
    resumed = [t for t in trials if os.path.join(os.path.dirname(trial), t)
               != trial][0]
    rows = _metrics(os.path.join(os.path.dirname(trial), resumed, "save"))
    assert [int(r["step"]) for r in rows] == [4]


class _FakeSystem:
    """Counts calls; steps are host integers as the real system's are."""

    class cfg:
        max_steps = 7

    def __init__(self):
        self.dens_steps, self.evals = [], []

    def train_step(self, state):
        return state + 1, {"loss": torch.tensor(1.0 / (state + 1)),
                           "n_alive": torch.tensor(10), "overflow":
                           torch.tensor(0)}

    def maybe_densify(self, state):
        if state % 3 == 0:
            self.dens_steps.append(state)
            from humangaussian_torch.densify import DensifyInfo

            one = torch.tensor(1)
            return state, DensifyInfo(one, one, one, one, one)
        return state, None

    def render_eval(self, scene, split):
        self.evals.append(split)
        return {"image": torch.zeros(2, 8, 8, 3)}, None

    def guidance_eval_snapshot(self, state):
        """Panels of two cameras, each a constant grey of its own: the
        render and pose at 32^2, the guidance images at 16^2."""
        self.evals.append(f"guidance {int(state)}")
        names = ("render", "pose", "imgs_1step", "imgs_final",
                 "depths_1step", "depths_final")
        return {k: torch.full((2,) + (32 if i < 2 else 16,) * 2 + (3,),
                              0.1 * (i + 1))
                for i, k in enumerate(names)}


class _State(int):
    ovf_streak = 0  # TrainState's ladder streak; no overflow is logged here

    @property
    def step(self):
        return int(self)

    @property
    def scene(self):
        return None

    def __add__(self, other):
        return _State(int(self) + other)


def test_run_training_schedule(tmp_path):
    system = _FakeSystem()
    lines = []
    state, history = run_training(system, _State(1), max_steps=7,
                                  val_interval=4, save_dir=str(tmp_path),
                                  log_every=2, log_fn=lines.append)
    assert int(state) == 7
    assert system.dens_steps == [3, 6]
    assert [r["step"] for r in history] == [2, 3, 4, 6]
    assert history[1]["n_cloned"] == 1
    assert system.evals == ["val"]
    assert os.path.exists(tmp_path / "it4-val.png")
    assert os.path.exists(tmp_path / "metrics.csv")
    # guidance_eval_interval writes the six-panel strip of the first camera
    system.evals.clear()
    run_training(system, _State(0), max_steps=6, val_interval=0,
                 save_dir=str(tmp_path), guidance_eval_interval=5,
                 log_fn=lines.append)
    assert system.evals == ["guidance 5"]
    from PIL import Image

    strip = np.asarray(Image.open(tmp_path / "it5-guidance.png"))
    assert strip.shape[:2] == (16, 6 * 16)
    np.testing.assert_allclose(strip[8, 8::16, 0] / 255.0,
                               [0.1, 0.2, 0.3, 0.4, 0.5, 0.6], atol=0.01)


class _ScriptedSystem:
    """`train_step` returns scripted `overflow` metrics and records the
    per-tile pair cap each step renders with."""

    class cfg:
        max_steps = 100

    def __init__(self, script):
        self.script = script  # step -> dropped pairs
        self.caps = []

    def train_step(self, state):
        self.caps.append(state.tile_cap)
        return state._replace(step=state.step + 1), {
            "loss": torch.tensor(1.0), "n_alive": torch.tensor(10),
            "overflow": torch.tensor(self.script(state.step))}

    def maybe_densify(self, state):
        return state, None


class _LadderState(NamedTuple):
    step: int
    tile_cap: int
    scene: object = None
    ovf_streak: int = 0


def _ladder_run(script, steps, tile_cap=4096):
    system, lines = _ScriptedSystem(script), []
    state, _ = run_training(system, _LadderState(0, tile_cap),
                            max_steps=steps, val_interval=0, log_every=1,
                            log_fn=lines.append)
    return system.caps, state, lines


def test_kcap_overflow_grows_tile_capacity():
    """Persistent drops over the threshold grow the cap 1.5x (rounded up
    to 128) every `OVERFLOW_PATIENCE` logged checks, up to the maximum."""
    caps, state, lines = _ladder_run(
        lambda step: OVERFLOW_GROW_THRESHOLD + 1, steps=30)
    assert caps[:OVERFLOW_PATIENCE + 1] == [4096] * OVERFLOW_PATIENCE + [6144]
    assert caps == sorted(caps) and caps[-1] == TILE_CAP_MAX
    assert sorted(set(caps)) == [4096, 6144, 9216, 13824, 20736, 31104,
                                 46720, TILE_CAP_MAX]
    assert all(c % 128 == 0 for c in caps)
    assert state.tile_cap == TILE_CAP_MAX
    assert any("tile_capacity 4096 -> 6144" in line for line in lines)
    assert grown_tile_cap(TILE_CAP_MAX) == TILE_CAP_MAX


@pytest.mark.parametrize("script", [
    lambda step: 50,  # drops below the threshold warn only
    lambda step: (OVERFLOW_GROW_THRESHOLD + 1) * (step % 3 != 2),  # gaps
    lambda step: 0,
], ids=["below-threshold", "interrupted", "none"])
def test_overflow_subsiding_stops_ladder(script):
    caps, state, lines = _ladder_run(script, steps=12)
    assert set(caps) == {4096} and state.tile_cap == 4096
    warned = any(line.startswith("WARNING") for line in lines)
    assert warned == any(script(s) for s in range(12))


def test_loggers_and_saving(tmp_path):
    path = str(tmp_path / "logs" / "m.csv")
    lg = loggers.MultiLogger([loggers.CSVLogger(path)])
    lg.log_scalars(1, {"loss": torch.tensor(0.5), "n": 3})
    lg.log_scalars(2, {"loss": 0.25, "n": 4})
    lg.log_image(2, "x", np.zeros((4, 4, 3)))
    lg.close()
    with open(path) as f:
        rows = list(csv.DictReader(f))
    assert [(r["step"], r["loss"]) for r in rows] == [("1", "0.5"),
                                                      ("2", "0.25")]
    frames = np.random.default_rng(0).random((3, 8, 8, 3))
    gif = saving.save_gif(str(tmp_path / "a.gif"), frames)
    from PIL import Image

    assert Image.open(gif).n_frames == 3
    grid = saving.save_image_grid(str(tmp_path / "g.png"),
                                  [np.zeros((16, 40, 3))] * 2,
                                  texts=["hello", None])
    img = np.asarray(Image.open(grid))
    assert img.shape == (16, 80, 3) and img[:, :40].max() > 0
    assert img[:, 40:].max() == 0
    saving.save_metrics_csv(str(tmp_path / "c.csv"),
                            [{"b": 1, "a": 2}, {"a": 3}])
    with open(tmp_path / "c.csv") as f:
        assert f.readline().strip() == "a,b"


def test_snapshot_code_copies_the_tracked_sources(tmp_path):
    dst = snapshot_code(str(tmp_path))
    if dst is None:
        pytest.skip("not inside a git checkout")
    assert os.path.isfile(os.path.join(dst, "humangaussian_torch",
                                       "__init__.py"))
    assert not os.path.exists(os.path.join(dst, ".git"))
