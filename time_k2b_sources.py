"""Time other sources of K2b (`hg_rasterize_bwd_rows`) against the
checkout's, on the inputs of chip_smoke.py's shapes (a)-(c).

    python3 time_k2b_sources.py NAME=PATH[:FLAG,FLAG] ...

Runs `chip_smoke.py --only render,guidance` on the card, keeping K2's
sub-tile rows, mask and routing at each shape it times K2b on (the 1024^2
avatar view, the first training view, the guidance step's batch of 8).
Then it builds each PATH (a `.cu` file with the C interface of
humangaussian_torch/csrc/rasterize_bwd.cu's `hg_rasterize_bwd_rows`, the
`.cuh` headers of csrc/ on its include path) with nvcc and the port's
flags plus `-DFLAG` for each FLAG, checks that each gives the bits of
`feature_row_grads_plain` on every shape, and prints its ms (CUDA events,
20 timings of 5 back-to-back launches, median) in two turns (A, B, ..., B,
A), beside the checkout's kernel launched the same way (chip_smoke's own
lines give the wrapper's call and `index_add_` of the same rows). Also
prints each shape's work: feature rows, candidates, masked sub-tile rows,
and the masked rows of a 32-row warp (mean, max). Needs one card; prints
the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

import chip_smoke
from humangaussian_torch import kernels
from humangaussian_torch.ops import rasterize_tiled as rt

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "build", "k2b_sources")


def build(name: str, spec: str):
    """The loaded `hg_rasterize_bwd_rows` of `spec` = PATH[:FLAG,FLAG]."""
    path, _, flags = spec.partition(":")
    so = os.path.join(OUT_DIR, name + ".so")
    cmd = [kernels.find_nvcc(), *kernels.NVCC_FLAGS,
           *(f"-D{f}" for f in flags.split(",") if f),
           "-I", str(kernels.CSRC_DIR), "-o", so, os.path.join(REPO, path)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stdout}{proc.stderr}")
    for line in (proc.stdout + proc.stderr).splitlines():
        if "registers" in line:
            print(f"{name}: {line.strip()}")
    fn = ctypes.CDLL(so).hg_rasterize_bwd_rows
    fn.argtypes = kernels.RASTERIZE_BWD_ROWS.argtypes
    fn.restype = ctypes.c_int
    return fn


def work_line(label, mask, cand_pos, row_starts, m):
    rs = row_starts.to(torch.int64)
    per_cand = torch.where(cand_pos >= 0, (mask != 0).sum(1), 0)
    csum = torch.cat([per_cand.new_zeros(1), torch.cumsum(per_cand, 0)])
    per_row = csum[rs[1:]] - csum[rs[:-1]]
    per_warp = torch.nn.functional.pad(per_row, (0, -m % 32)).reshape(
        -1, 32).sum(1)
    print(f"== {label}: {m} feature rows, {cand_pos.numel()} candidates, "
          f"{int(per_cand.sum())} masked sub-tile rows; a 32-row warp's "
          f"mean {float(per_warp.double().mean()):.1f}, max "
          f"{int(per_warp.max())}", flush=True)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("time_k2b_sources.py needs a CUDA card", file=sys.stderr)
        return 1
    specs = dict(a.split("=", 1) for a in argv)
    os.makedirs(OUT_DIR, exist_ok=True)
    with ThreadPoolExecutor(max(len(specs), 1)) as pool:
        fns = dict(zip(specs, pool.map(lambda kv: build(*kv),
                                       specs.items())))
    kernels.build_all()
    fns = {"checkout": kernels.RASTERIZE_BWD_ROWS.function(), **fns}

    inputs = {}
    k2_times = chip_smoke.k2_times

    def keep_inputs(label, kargs, routing, bg, tiles, cfg, fwd, cot,
                    plain=True):
        rows, mask = rt.composite_backward_pairs(*kargs, bg, fwd, cot,
                                                 *tiles, cfg, routing)
        inputs[label] = (rows, mask, *routing[:2], kargs[0])
        return k2_times(label, kargs, routing, bg, tiles, cfg, fwd, cot,
                        plain)

    chip_smoke.k2_times = keep_inputs
    chip_smoke.run(torch.device("cuda"), ("render", "guidance"))
    print(f"card: {chip_smoke.card_line()}", flush=True)

    for label, (rows, mask, cand_pos, row_starts, feats) in inputs.items():
        m = feats.shape[0]
        work_line(label, mask, cand_pos, row_starts, m)
        want = rt.feature_row_grads_plain(rows, mask, cand_pos, row_starts,
                                          feats)
        stream = torch.cuda.current_stream().cuda_stream
        outs = {}

        def launch(name):
            rc = fns[name](rows.data_ptr(), mask.data_ptr(),
                           cand_pos.data_ptr(), row_starts.data_ptr(),
                           feats.data_ptr(), m, outs[name].data_ptr(),
                           stream)
            chip_smoke.check(rc == 0, f"{name}: launch failed ({rc})")

        for name in fns:
            outs[name] = torch.full_like(feats, float("nan"))
            launch(name)
            torch.cuda.synchronize()
            chip_smoke.check(
                torch.equal(outs[name].view(torch.int32),
                            want.view(torch.int32)),
                f"{label}: {name} differs from feature_row_grads_plain")
        times = {name: [] for name in fns}
        for name in [*fns, *reversed(fns)]:
            times[name].append(chip_smoke.cuda_ms(lambda: launch(name),
                                                  reps=20, inner=5))
        for name, ts in times.items():
            print(f"  {label} {name}: {statistics.mean(ts):.4f} ms (turns "
                  f"{' '.join(f'{t:.4f}' for t in ts)}), bit-equal to plain")
    print(f"card: {chip_smoke.card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
