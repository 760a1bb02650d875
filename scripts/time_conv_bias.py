"""The conv bias kernel (csrc/conv_bias.cu) on the card: checked against
aten's `add_` and timed beside it at the VAE encoder's output sizes, its
host cost per call, a full-width encode's device time by kernel and
launching operation with the kernel and with the library add, and the
generic elementwise kernels of one profiled `sd2_body` step by the
operation that launched them.

    python3 scripts/time_conv_bias.py [--seed N] [--parts kernels,host,...]

Needs an NVIDIA card; imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from humangaussian_torch import kernels  # noqa: E402
from humangaussian_torch.guidance import vae as port_vae  # noqa: E402
from humangaussian_torch.ops import conv_bias  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
# the encoder's convolution outputs at batch 8 (512^2 images), bf16:
# (C, H, W) and how many convolutions of one encode write that size
ENCODER_OUTPUTS = [((128, 512, 512), 5), ((128, 256, 256), 1),
                   ((256, 256, 256), 5), ((256, 128, 128), 1),
                   ((512, 128, 128), 5), ((512, 64, 64), 9),
                   ((8, 64, 64), 2)]
ELEMENTWISE = "elementwise_kernel<128, 4,"


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    return f"{out}; torch {torch.__version__}, CUDA {torch.version.cuda}"


def device_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_table(dtype=torch.bfloat16):
    """Per output size: bit-equal to aten, kernel and aten ms (medians of
    four rounds in turns), the bound by bytes and each one's share of it.
    Each call takes the next of enough copies of y to overflow the 50 MB
    L2, so no call finds its tensor there."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    print(f"shape (B = 8), {dtype}, channels_last | kernel ms | aten add_ "
          f"ms | bound ms | kernel share | aten share | bit-equal")
    total = {"kernel": 0.0, "aten": 0.0, "bound": 0.0}
    for (c, h, w), per_encode in ENCODER_OUTPUTS:
        y = torch.randn((8, c, h, w), generator=gen, device="cuda",
                        dtype=dtype).contiguous(
                            memory_format=torch.channels_last)
        bias = torch.randn((c,), generator=gen, device="cuda", dtype=dtype)
        want = conv_bias.conv_bias_add_plain(y.clone(), bias)
        got = conv_bias.conv_bias_add(y.clone(), bias)
        same = torch.equal(got, want)
        del got, want
        size = y.numel() * y.element_size()
        ys = [y] + [y.clone() for _ in range(-(-200_000_000 // size) - 1)]
        turn = [0]

        def next_y():
            turn[0] = (turn[0] + 1) % len(ys)
            return ys[turn[0]]

        fns = {"kernel": lambda: conv_bias.conv_bias_add(next_y(), bias),
               "aten": lambda: conv_bias.conv_bias_add_plain(next_y(), bias)}
        reps = max(8, int(4e9 / size))
        for fn in fns.values():
            device_ms(fn, 2)
        times = {k: [] for k in fns}
        for order in (("kernel", "aten"), ("aten", "kernel")) * 2:
            for k in order:
                times[k].append(device_ms(fns[k], reps))
        ms = {k: statistics.median(v) for k, v in times.items()}
        bound = 2 * size / HBM_BYTES_PER_S * 1e3
        print(f"[8, {c}, {h}, {w}] x{per_encode} | {ms['kernel']:.5f} | "
              f"{ms['aten']:.5f} | {bound:.5f} | "
              f"{100 * bound / ms['kernel']:.1f}% | "
              f"{100 * bound / ms['aten']:.1f}% | {same}")
        for k in ("kernel", "aten"):
            total[k] += per_encode * ms[k]
        total["bound"] += per_encode * bound
        del y, ys, bias
        torch.cuda.empty_cache()
    print(f"one encode's bias adds (ms, the sizes above x their counts): "
          f"kernel {total['kernel']:.4f}, aten {total['aten']:.4f}, bound "
          f"{total['bound']:.4f}; five encodes: kernel "
          f"{5 * total['kernel']:.3f}, aten {5 * total['aten']:.3f}, bound "
          f"{5 * total['bound']:.3f}")


def host_us(fn, calls: int = 3000) -> float:
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def host_table():
    """Host microseconds a call on small tensors (the device keeps up),
    medians of three rounds in turns."""
    y = torch.randn((1, 128, 8, 8), device="cuda",
                    dtype=torch.bfloat16).contiguous(
                        memory_format=torch.channels_last)
    bias = torch.randn((128,), device="cuda", dtype=torch.bfloat16)
    conv = port_vae.BiasConv2d(128, 128, 3, padding=1).to(
        "cuda", torch.bfloat16, memory_format=torch.channels_last)
    conv.requires_grad_(False)
    w, b = conv.weight, conv.bias
    args = (y.data_ptr(), bias.data_ptr(), y.numel(), 128, 1, 1, 0,
            torch.cuda.current_stream().cuda_stream)
    fns = {
        "the ctypes launch alone": lambda: kernels.CONV_BIAS_ADD.launch(
            *args),
        "conv_bias_add": lambda: conv_bias.conv_bias_add(y, bias),
        "aten add_": lambda: conv_bias.conv_bias_add_plain(y, bias),
        "BiasConv2d.forward": lambda: port_vae.BiasConv2d.forward(conv, y),
        "nn.Conv2d.forward": lambda: torch.nn.Conv2d.forward(conv, y),
        "F.conv2d with bias": lambda: F.conv2d(y, w, b, 1, 1),
        "F.conv2d without": lambda: F.conv2d(y, w, None, 1, 1),
    }
    times = {k: [] for k in fns}
    for _ in range(3):
        for k, fn in fns.items():
            times[k].append(host_us(fn))
    print("host us a call (median of 3 rounds of 3000 calls): " + ", ".join(
        f"{k} {statistics.median(v):.2f}" for k, v in times.items()))


def _enclosing(intervals, points) -> dict:
    """For each (ts, key) of `points`, the names of the `intervals` (start,
    end, name), properly nested as on one thread, that contain ts, outer
    first."""
    intervals = sorted(intervals, key=lambda iv: (iv[0], -iv[1]))
    out, stack, j = {}, [], 0
    for ts, key in sorted(points):
        while j < len(intervals) and intervals[j][0] <= ts:
            iv = intervals[j]
            j += 1
            while stack and stack[-1][1] < iv[0]:
                stack.pop()
            stack.append(iv)
        while stack and stack[-1][1] < ts:
            stack.pop()
        out[key] = [name for _, _, name in stack]
    return out


def device_ops(prof) -> list:
    """Every device operation of the profile as (name, ms, chain): chain
    is the host operations and spans around its launch on the launching
    thread, outer first (the Chrome trace's correlation ids)."""
    import json
    import tempfile

    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    launches, host, dev = {}, {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, corr = e.get("cat", ""), e.get("args", {}).get("correlation")
        if cat in ("cuda_runtime", "cuda_driver") and corr is not None:
            launches[corr] = (float(e["ts"]), e["tid"])
        elif cat in ("cpu_op", "user_annotation"):
            ts = float(e["ts"])
            host.setdefault(e["tid"], []).append(
                (ts, ts + float(e.get("dur", 0.0)), e["name"]))
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            dev.append((e["name"], float(e.get("dur", 0.0)) / 1e3, corr))
    points = {}
    for i, (_, _, corr) in enumerate(dev):
        if corr in launches:
            ts, tid = launches[corr]
            points.setdefault(tid, []).append((ts, i))
    chains = {}
    for tid, pts in points.items():
        chains.update(_enclosing(host.get(tid, []), pts))
    return [(name, ms, chains.get(i, [])) for i, (name, ms, _) in
            enumerate(dev)]


def op_chain(chain: list) -> str:
    """The launching operation, the outermost aten operation around it and
    the innermost program span (`hg.*`) or autograd node above it."""
    aten = [n for n in chain if n.startswith("aten::")]
    spans = [n for n in chain if n.startswith(("hg.", "autograd::"))]
    return (f"{chain[-1] if chain else '-'} < {aten[0] if aten else '-'} < "
            f"{spans[-1] if spans else '-'}")


def short_name(name: str) -> str:
    """A kernel's name cut to 60 characters, with the functor of an aten
    elementwise kernel (which the cut would drop) after it."""
    import re

    functor = re.search(r"(\w*Functor\w*|direct_copy_kernel_cuda|\w+_kernel_"
                        r"cuda|\w+KernelImpl\w*)", name[60:])
    return name[:60] + (f" [{functor.group(1)}]" if functor else "")


def by_launching_op(ops, match=None, top=12) -> list:
    """Device ms summed by (kernel name, op chain)."""
    by = {}
    for name, ms, chain in ops:
        if match is None or match in name:
            key = (short_name(name), op_chain(chain))
            by[key] = by.get(key, 0.0) + ms
    return sorted(by.items(), key=lambda kv: -kv[1])[:top]


def print_ops(label, rows):
    print(label)
    for (name, chain), ms in rows:
        print(f"  {ms:10.4f} ms  {name}  <=  {chain}")


def encode_profile():
    """A full-width bf16 encode at batch 8, 512^2 (no grad): bit-equal to
    the library add's encode, and its device time by kernel, both ways."""
    from torch.profiler import ProfilerActivity, profile

    torch.manual_seed(0)
    vae = port_vae.AutoencoderKL(port_vae.VAEConfig()).to("cuda")
    vae.to(memory_format=torch.channels_last).requires_grad_(False)
    gen = torch.Generator(device="cuda").manual_seed(1)
    img = torch.rand((8, 512, 512, 3), generator=gen, device="cuda") * 2 - 1
    convs = [m for m in vae.modules() if isinstance(m, port_vae.BiasConv2d)]

    def library(on: bool):
        for m in convs:
            if on:
                m.forward = torch.nn.Conv2d.forward.__get__(m)
            elif "forward" in vars(m):
                del m.forward

    outs = {}
    for way in ("kernel", "library"):
        library(way == "library")
        with torch.no_grad():
            for _ in range(2):
                outs[way] = vae.encode(img)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                vae.encode(img)
                torch.cuda.synchronize()
        ops = device_ops(prof)
        rows = by_launching_op(ops)
        dev = sum(ms for _, ms, _ in ops)
        print_ops(f"encode with the {way} bias add: device {dev:.3f} ms, "
                  f"conv_bias_add launches "
                  f"{kernels.launch_counts()['conv_bias_add']}", rows)
    library(False)
    same = all(torch.equal(a, b) for a, b in zip(outs["kernel"],
                                                  outs["library"]))
    print(f"encode mean / logvar bit-equal, kernel vs library add: {same}")
    del vae, img, outs
    torch.cuda.empty_cache()


def step_profile(seed: int):
    """One `sd2_body` unit (train_step + maybe_densify) of the benchmark's
    cell, profiled with the kernel and then with the library add (every
    BiasConv2d's forward set to nn.Conv2d.forward): the generic
    elementwise kernels and the conv bias kernel by launching op."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from portbench.harness import load_json, load_module

    bench = os.path.join(ROOT, "portbench")
    conf = load_json(bench, "configs", "hg_avatar_sd2.json")
    traffic = load_json(bench, "workloads", "sd2_body.json")
    mod = load_module(os.path.join(bench, "configs", "hg_avatar_sd2.py"),
                      "hg_avatar_sd2")
    cell = mod.build(seed, "cuda", conf, traffic)
    own = port_vae.BiasConv2d.forward
    try:
        for way in ("kernel", "library"):
            if way == "library":
                port_vae.BiasConv2d.forward = torch.nn.Conv2d.forward
            for _ in range(2):
                cell.run_unit()
            cell.synchronize()
            kernels.reset_launch_counts()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                cell.run_unit()
                cell.synchronize()
            ops = device_ops(prof)
            dev = sum(ms for _, ms, _ in ops)
            print(f"sd2_body step (seed {seed}) with the {way} bias add: "
                  f"device {dev:.3f} ms; launches "
                  f"{json.dumps(kernels.launch_counts())}")
            print_ops("  generic elementwise kernels by launching op:",
                      by_launching_op(ops, ELEMENTWISE, top=16))
            print_ops("  the conv bias kernel:",
                      by_launching_op(ops, "bias_add"))
            print_ops("  top kernels:", by_launching_op(ops, top=12))
    finally:
        port_vae.BiasConv2d.forward = own


def _clone(x):
    """A deep copy of a train state or its metrics (tensors, dicts, named
    tuples, the generator's state)."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[_clone(v) for v in x])
    if isinstance(x, torch.Generator):
        gen = torch.Generator(device=x.device)
        gen.set_state(x.get_state())
        return gen
    return x


def _tensors(x, name=""):
    if isinstance(x, torch.Tensor):
        yield name, x
    elif isinstance(x, dict):
        for k, v in x.items():
            yield from _tensors(v, f"{name}.{k}")
    elif isinstance(x, (tuple, list)):
        for k, v in zip(getattr(x, "_fields", range(len(x))), x):
            yield from _tensors(v, f"{name}.{k}")


def same_bits(seed: int, steps: int = 3):
    """`steps` train_steps of the `sd2_body` cell's system from a copy of
    its state after set-up: with the kernel, again with the kernel, and
    with the library add; the tensors of the states and metrics that
    differ bit for bit, with torch's deterministic algorithms strict and
    with them off."""
    from portbench.harness import load_json, load_module

    bench = os.path.join(ROOT, "portbench")
    mod = load_module(os.path.join(bench, "configs", "hg_avatar_sd2.py"),
                      "hg_avatar_sd2")
    cell = mod.build(seed, "cuda", load_json(bench, "configs",
                                             "hg_avatar_sd2.json"),
                     load_json(bench, "workloads", "sd2_body.json"))
    system, state0 = cell.system, _clone(cell.state)
    own = port_vae.BiasConv2d.forward

    def run(library: bool):
        port_vae.BiasConv2d.forward = (torch.nn.Conv2d.forward if library
                                       else own)
        try:
            state, out = _clone(state0), []
            for _ in range(steps):
                state, metrics = system.train_step(state)
                out.append(_clone(metrics))
            torch.cuda.synchronize()
            return dict(_tensors((state, out)))
        finally:
            port_vae.BiasConv2d.forward = own

    def differ(a, b):
        return [k for k in a if not torch.equal(a[k], b[k])]

    for strict in (True, False):
        torch.use_deterministic_algorithms(strict)
        first, again, library = run(False), run(False), run(True)
        print(f"sd2_body, seed {seed}, {steps} train_steps, deterministic "
              f"algorithms {'strict' if strict else 'off'}: {len(first)} "
              f"tensors; kernel vs kernel differ in "
              f"{differ(first, again)[:8]}, kernel vs library add in "
              f"{differ(first, library)[:8]}")
    torch.use_deterministic_algorithms(False)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=2718281829)
    ap.add_argument("--parts", default="kernels,host,encode,step",
                    help="comma-separated of kernels, host, encode, step, "
                         "bits (bits sets CUBLAS_WORKSPACE_CONFIG: run it "
                         "alone)")
    args = ap.parse_args(argv)
    parts = args.parts.split(",")
    if "bits" in parts:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 3
    print(card())
    torch.backends.cudnn.allow_tf32 = False
    kernels.CONV_BIAS_ADD.function()
    print("\n".join(line for line in kernels.CONV_BIAS_ADD.build_log
                    .splitlines() if "ptxas" in line) or "(library reused)")
    if "kernels" in parts:
        kernel_table(torch.bfloat16)
        kernel_table(torch.float32)
    if "host" in parts:
        host_table()
    if "encode" in parts:
        encode_profile()
    if "step" in parts:
        step_profile(args.seed)
    if "bits" in parts:
        same_bits(args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
