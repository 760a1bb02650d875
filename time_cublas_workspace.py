#!/usr/bin/env python3
"""Host and device time of single products under CUBLAS_WORKSPACE_CONFIG
settings, on one CUDA card.

    python3 time_cublas_workspace.py [SETTING ...]

SETTING is a value of CUBLAS_WORKSPACE_CONFIG (":4096:8", ":16:8") or
"none" (the variable removed); the default compares none, ":4096:8" and
":16:8". cuBLAS reads the variable once per process, so each setting runs
in a child process of its own, in turns (the settings, then the settings
reversed). For products of the UNet's and the VAE's shapes (`F.linear`,
bfloat16 with a bias and without, and float32), each child prints the
host time to enqueue one call, the wall time per call of a loop ended by
a synchronize, and the device time per call from CUDA events, each over
2000 calls after 50 warm-up calls.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

SHAPES = (  # (label, dtype, rows, in, out, bias)
    ("bf16 8192x320 -> 320 + bias", "bfloat16", 8192, 320, 320, True),
    ("bf16 512x1280 -> 1280 + bias", "bfloat16", 512, 1280, 1280, True),
    ("bf16 154x1024 -> 320", "bfloat16", 154, 1024, 320, False),
    ("f32 4096x512 -> 512", "float32", 4096, 512, 512, False),
)
REPS = 2000


def child() -> None:
    import torch
    import torch.nn.functional as F

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    setting = os.environ.get("CUBLAS_WORKSPACE_CONFIG", "none")
    for label, dtype, m, k, n, bias in SHAPES:
        dt = getattr(torch, dtype)
        x = torch.randn(m, k, device=dev, dtype=dt)
        w = torch.randn(n, k, device=dev, dtype=dt)
        b = torch.randn(n, device=dev, dtype=dt) if bias else None
        for _ in range(50):
            F.linear(x, w, b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REPS):
            F.linear(x, w, b)
        host = (time.perf_counter() - t0) / REPS * 1e6
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / REPS * 1e6
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            F.linear(x, w, b)
        end.record()
        end.synchronize()
        device = start.elapsed_time(end) / REPS * 1e3
        print(f"  {setting:>8} {label}: enqueue {host:.2f} us, wall "
              f"{wall:.2f} us, device {device:.2f} us a call", flush=True)


def main(settings) -> int:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(out.stdout.strip())
    for setting in list(settings) + list(reversed(settings)):
        env = dict(os.environ)
        env.pop("CUBLAS_WORKSPACE_CONFIG", None)
        if setting != "none":
            env["CUBLAS_WORKSPACE_CONFIG"] = setting
        subprocess.run([sys.executable, os.path.abspath(__file__), "--child"],
                       env=env, check=True, timeout=300)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--child"]:
        child()
        sys.exit(0)
    sys.exit(main(sys.argv[1:] or ["none", ":4096:8", ":16:8"]))
