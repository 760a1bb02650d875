"""The port's `hg.*` spans (utils/profiling.py::trace_annotation): where
they sit in a tiny training step and a tiny animated frame under
`torch.profiler`, that they cost no `record_function` and change no bit
when no profiler runs, and the benchmark's readers of them
(`portbench/metrics/`, on hand-written Chrome traces)."""
import json
import os
import types

import numpy as np
import pytest
import torch

from humangaussian_torch.apps.animate import render_motion_frame
from humangaussian_torch.train.loop import _read, run_training
from portbench import harness
from portbench.trace import Trace
from port_parity_torch import tiny_port_system

torch.set_num_threads(2)
STEP_LAYERS = ("hg.inputs", "hg.render", "hg.guidance", "hg.backward",
               "hg.optim", "hg.densify")
BATCH = 2


def _spans(prof, tmp_path) -> list:
    """(name, start, end, thread) of every `hg.*` span of the trace."""
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [(e["name"], e["ts"], e["ts"] + e["dur"], e["tid"])
            for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"
            and e["name"].startswith("hg.")]


def _profiled(fn, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof, tmp_path)


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _within(child, parent) -> bool:
    return parent[1] <= child[1] and child[2] <= parent[2]


def _parent_of(child, spans, name):
    """The `name` span that holds `child` in time, or None."""
    hits = [p for p in _named(spans, name) if _within(child, p)]
    assert len(hits) <= 1, (child, hits)
    return hits[0] if hits else None


def _quiet(*_args, **_kwargs):
    pass


def _train(system, steps, log_every=1):
    state = system.init_state(0)
    return run_training(system, state, max_steps=steps, val_interval=0,
                        log_every=log_every, log_fn=_quiet)


def test_step_spans_nest_as_stated(tmp_path):
    """Three steps (density control at the third): every layer span sits
    in its step and no two of them overlap; the render's, the guidance's
    and the backward's children sit in their parents; one `hg.read.bin`
    a camera, one metrics read a logged step."""
    system = tiny_port_system(seed=0, batch=BATCH)
    _, spans = _profiled(lambda: _train(system, 3), tmp_path)
    steps = _named(spans, "hg.step")
    assert len(steps) == 3
    main = steps[0][3]
    layers = [s for s in spans if s[0] in STEP_LAYERS
              or s[0] in ("hg.read.log", "hg.read.densify_info")]
    for name in STEP_LAYERS[:5]:
        assert len(_named(spans, name)) == 3, name
    assert len(_named(spans, "hg.densify")) == 1
    assert len(_named(spans, "hg.read.log")) == 3
    assert len(_named(spans, "hg.read.densify_info")) == 1
    for s in layers:
        assert s[3] == main and _parent_of(s, spans, "hg.step"), s
    layers.sort(key=lambda s: s[1])
    for a, b in zip(layers, layers[1:]):
        assert a[2] <= b[1], (a, b)
    for child, parent, per_parent in (
            ("hg.render.project", "hg.render", 1),
            ("hg.render.bin", "hg.render", 1),
            ("hg.render.composite", "hg.render", 1),
            ("hg.read.bin", "hg.render.bin", BATCH),
            ("hg.guidance.unet", "hg.guidance", 1),
            ("hg.render.composite_bwd", "hg.backward", 1),
            ("hg.read.densify", "hg.densify", None)):
        kids = _named(spans, child)
        assert kids, child
        held = [_parent_of(k, spans, parent) for k in kids]
        assert all(held), child
        if per_parent is not None:
            assert len(kids) == per_parent * len(_named(spans, parent)), child
    # the resizes and the three encodes in the forward, the two
    # differentiated encodes again in the backward (their recompute)
    encodes = _named(spans, "hg.guidance.encode")
    fwd = [e for e in encodes if _parent_of(e, spans, "hg.guidance")]
    bwd = [e for e in encodes if _parent_of(e, spans, "hg.backward")]
    assert len(fwd) == 3 * 2 * 3 and len(bwd) == 3 * 2
    assert len(fwd) + len(bwd) == len(encodes)
    for s in spans:
        if s[0].startswith("hg.read."):
            assert _parent_of(s, spans, "hg.step"), s
    for name, per_step, parent in (("hg.read.cameras", 26, "hg.inputs"),
                                   ("hg.read.pose_image", 4, "hg.inputs"),
                                   ("hg.read.time_ids", 1, "hg.guidance.unet"),
                                   ("hg.read.camera", 2, None)):
        got = _named(spans, name)
        assert len(got) == 3 * per_step, name
        assert parent is None or all(_parent_of(s, spans, parent)
                                     for s in got), name


def _animator_and_motion(n=2000, seed=0):
    from humangaussian_torch.animation import AvatarAnimator
    from humangaussian_torch.convert import scene_from_numpy, smplx_from_numpy
    from humangaussian_torch.smplx.model import toy_model
    from humangaussian_torch.smplx.skeleton import sample_mesh_surface

    model = toy_model()
    v = model.v_template
    verts_n = ((v - (v.max(0) + v.min(0)) / 2)
               * (0.6 / np.max(v.max(0) - v.min(0)) * 1.1 ** 10))
    rng = np.random.RandomState(seed)
    pts = sample_mesh_surface(verts_n, model.faces, n, seed)
    scene = scene_from_numpy(dict(
        means=pts.astype(np.float32),
        log_scales=np.full((n, 3), np.log(0.01), np.float32),
        quats=rng.randn(n, 4).astype(np.float32),
        sh_dc=rng.randn(n, 3).astype(np.float32) * 0.5,
        sh_rest=np.zeros((n, 3, 3), np.float32),
        opacity_logits=np.ones((n, 1), np.float32),
        alive=np.ones(n, bool)), device="cpu")
    animator = AvatarAnimator(scene, smplx_from_numpy(model, device="cpu"))
    motion = (rng.randn(3, 21, 3) * 0.3).astype(np.float32)
    return animator, motion


def _frames(animator, motion):
    args = types.SimpleNamespace(size=64, radius=2.0, rotate=True)
    bg = torch.ones(3)
    return [render_motion_frame(animator, motion[i], i, len(motion), args,
                                bg) for i in range(len(motion))]


def test_frame_spans_nest_as_stated(tmp_path):
    animator, motion = _animator_and_motion()
    frames, spans = _profiled(lambda: _frames(animator, motion), tmp_path)
    assert len(frames) == 3 and frames[0].shape == (64, 64, 3)
    for name, n, parent in (("hg.frame", 3, None),
                            ("hg.repose", 3, "hg.frame"),
                            ("hg.render", 3, "hg.frame"),
                            ("hg.render.project", 3, "hg.render"),
                            ("hg.render.bin", 3, "hg.render"),
                            ("hg.render.composite", 3, "hg.render"),
                            ("hg.read.bin", 3, "hg.render.bin"),
                            ("hg.read.frame", 3, "hg.frame"),
                            ("hg.read.frame_pose", 3, "hg.frame"),
                            ("hg.read.frame_camera", 6, "hg.frame"),
                            ("hg.read.fovy", 3, "hg.frame"),
                            ("hg.read.camera", 6, "hg.frame"),
                            ("hg.read.lbs", 3, "hg.repose")):
        got = _named(spans, name)
        assert len(got) == n, name
        if parent:
            assert all(_parent_of(s, spans, parent) for s in got), name
    a, b = _named(spans, "hg.repose"), _named(spans, "hg.render")
    assert all(r[2] <= d[1] for r, d in zip(a, b))


class _Counting:
    """Stands in for `torch.profiler.record_function`, counting entries."""

    entered = 0

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        type(self).entered += 1
        return self

    def __exit__(self, *exc):
        return False


def test_no_record_function_without_a_profiler(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _Counting)
    _Counting.entered = 0
    system = tiny_port_system(seed=0, batch=BATCH)
    _train(system, 3)
    animator, motion = _animator_and_motion(n=500)
    _frames(animator, motion[:1])
    assert _Counting.entered == 0
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        _frames(animator, motion[:1])
    assert _Counting.entered >= 10  # the spans do go through it


def test_profiler_leaves_the_step_bit_identical(tmp_path):
    """Two steps from one seed, with and without a profiler: the same
    parameters, Adam moments, statistics and metrics, bit for bit."""
    def run():
        return _train(tiny_port_system(seed=0, batch=BATCH), 2)

    plain, plain_hist = run()
    (traced, traced_hist), spans = _profiled(run, tmp_path)
    assert _named(spans, "hg.step")
    for name, a in plain.scene.params().items():
        assert torch.equal(a, traced.scene.params()[name]), name
    for moment in ("mu", "nu"):
        for name, a in getattr(plain.adam, moment).items():
            assert torch.equal(a, getattr(traced.adam, moment)[name]), name
    for a, b in zip(plain.densify, traced.densify):
        assert torch.equal(a, b)
    for a, b in zip(plain_hist, traced_hist):
        assert {k: v for k, v in a.items() if k != "steps_per_s"} == \
            {k: v for k, v in b.items() if k != "steps_per_s"}


def test_metrics_read_in_one_copy_as_float_reads_them():
    metrics = {"loss": torch.tensor(0.1234567, dtype=torch.float32),
               "n_alive": torch.tensor(2 ** 40 + 3),
               "overflow": torch.tensor(7, dtype=torch.int32),
               "flag": torch.tensor(True)}
    assert _read(metrics, "log") == {k: float(v) for k, v in metrics.items()}


# ---- the readers of the spans (portbench/metrics/), on written traces ----
def _metric(name):
    return harness.load_module(
        os.path.join(harness.HERE, "metrics", f"{name}.py"), f"m_{name}")


def _span(name, start, end, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": start,
            "dur": end - start, "tid": tid}


def _op(start, end, launch, corr):
    return [{"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": start,
             "dur": end - start, "args": {"correlation": corr}},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "ts": launch, "dur": 0.1, "args": {"correlation": corr}}]


def _train_trace():
    """Two steps in a 100 us window. Step 1 (0-50): inputs 2-10, render
    10-20 (two binning reads), guidance 20-35 (encode 21-25, UNet
    25-34), backward 35-45 (the encode's recompute 36-39 on another
    thread), optim 45-48; kernels at 5-8, 12-18, 22-30 (launched in the
    encode), 30-40 (in the UNet), 41-44 (in the recompute). Step 2
    (50-100): the same shifted by 50, one more kernel 96-99 launched in
    optim, and the loop's metrics read 99-99.5."""
    ev = [_span("portbench.window", 0, 100)]
    corr = 0
    for base in (0, 50):
        ev += [_span("hg.step", base, base + 50),
               _span("hg.inputs", base + 2, base + 10),
               _span("hg.render", base + 10, base + 20),
               _span("hg.read.bin", base + 12, base + 13),
               _span("hg.read.bin", base + 15, base + 16),
               _span("hg.guidance", base + 20, base + 35),
               _span("hg.guidance.encode", base + 21, base + 25),
               _span("hg.guidance.unet", base + 25, base + 34),
               _span("hg.backward", base + 35, base + 45),
               _span("hg.guidance.encode", base + 36, base + 39, tid=2),
               _span("hg.optim", base + 45, base + 48)]
        for s, e, launch in ((5, 8, 3), (12, 18, 11), (22, 30, 21.5),
                             (30, 40, 26), (41, 44, 37)):
            corr += 1
            ev += _op(base + s, base + e, base + launch, corr)
    ev += _op(96, 99, 96, 99) + [_span("hg.read.log", 99, 99.5)]
    return ev


def _ctx(events, units):
    return types.SimpleNamespace(trace=Trace(events), traced_units=units)


def test_train_readers_split_the_idle_time_as_worked_by_hand():
    """Idle in step 1: 0-5, 8-12, 18-22, 40-41, 44-50 (20 us): inputs 3 +
    2, render 2 + 2, guidance 2, backward 1 + 1, optim 3, the rest 2 + 2.
    Step 2 (17 us): the same but optim 1 (95-96) and the rest 2 + 1
    (50-52, 99-100). A step: 5, 4, 2, 2, 2 and 3.5 us."""
    ctx = _ctx(_train_trace(), 2)
    want = {"inputs_idle_ms.train": 5e-3, "render_idle_ms.train": 4e-3,
            "guidance_idle_ms.train": 2e-3, "backward_idle_ms.train": 2e-3,
            "optim_idle_ms.train": 2e-3, "loop_idle_ms.train": 3.5e-3}
    got = {name: _metric(name).read(ctx) for name in want}
    assert got == pytest.approx(want)
    idle = _metric("idle_share.train").read(ctx) / 100.0
    assert sum(got.values()) == pytest.approx(
        idle * ctx.trace.window_s / 2 * 1e3)
    # encodes: 22-30 and 41-44 a step (8 + 3 us); the UNet 30-40
    assert _metric("encode_dev_ms.train").read(ctx) == pytest.approx(11e-3)
    assert _metric("unet_dev_ms.train").read(ctx) == pytest.approx(10e-3)
    assert _metric("host_reads.train").read(ctx) == pytest.approx(2.5)


def test_serve_readers_split_the_idle_time_as_worked_by_hand():
    """Two frames in 20 us: re-pose 1-3, render 3-7 (one binning read),
    the copy 7-9, kernels 2-4 and 5-8; the second frame shifted by 10.
    Idle 0-2, 4-5, 8-12, 14-15, 18-20 (10 us): re-pose 1 + 1, render
    1 + 1, the rest 1 + 3 + 2."""
    ev = [_span("portbench.window", 0, 20)]
    for i, base in enumerate((0, 10)):
        ev += [_span("hg.frame", base, base + 10),
               _span("hg.repose", base + 1, base + 3),
               _span("hg.render", base + 3, base + 7),
               _span("hg.read.bin", base + 4, base + 5),
               _span("hg.read.frame", base + 7, base + 9)]
        ev += _op(base + 2, base + 4, base + 1.5, 2 * i + 1)
        ev += _op(base + 5, base + 8, base + 4.5, 2 * i + 2)
    ctx = _ctx(ev, 2)
    want = {"repose_idle_ms.serve": 1e-3, "render_idle_ms.serve": 1e-3,
            "frame_idle_ms.serve": 3e-3}
    got = {name: _metric(name).read(ctx) for name in want}
    assert got == pytest.approx(want)
    idle = _metric("idle_share.serve").read(ctx) / 100.0
    assert sum(got.values()) == pytest.approx(
        idle * ctx.trace.window_s / 2 * 1e3)
    assert _metric("host_reads.serve").read(ctx) == pytest.approx(2.0)


def test_idle_split_sums_to_the_idle_time_when_spans_overlap():
    from portbench.metrics._hg_spans import idle_split

    ev = [_span("portbench.window", 0, 30), _span("a", 1, 12),
          _span("b", 8, 20), _span("b", 9, 25)] + _op(3, 6, 0, 1) \
        + _op(14, 16, 0, 2)
    split = idle_split(Trace(ev), ("a", "b"))
    # idle 0-3, 6-14, 16-30: a takes 1-3 and 6-12, b 12-14 and 16-25
    assert split == pytest.approx({"a": 8e-6, "b": 11e-6, None: 6e-6})


@pytest.mark.parametrize("name", [
    "inputs_idle_ms.train", "render_idle_ms.train", "guidance_idle_ms.train",
    "backward_idle_ms.train", "optim_idle_ms.train", "loop_idle_ms.train",
    "encode_dev_ms.train", "unet_dev_ms.train", "host_reads.train",
    "repose_idle_ms.serve", "render_idle_ms.serve", "frame_idle_ms.serve",
    "host_reads.serve"])
def test_readers_find_nothing_without_the_programs_spans(name):
    """A program without the spans: only the benchmark's own ranges."""
    ev = [_span("portbench.window", 0, 20),
          _span("portbench.render_frame", 1, 9)] + _op(2, 4, 1.5, 1)
    assert _metric(name).read(_ctx(ev, 1)) is None
    assert _metric(name).read(types.SimpleNamespace(trace=None,
                                                    traced_units=0)) is None
