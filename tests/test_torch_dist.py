"""Camera-data-parallel training of the port (dist/parallel.py) over two
gloo CPU ranks, as tests/test_dist.py and tests/test_multiprocess.py hold
the JAX step: the data-parallel step must equal the port's single-process
`train_step` (loss within 2e-4 relative, means within 1e-5, grad_accum
within 1e-6, max_radii2d exact, the generator left in the same state) and
the ranks must agree bit for bit on the replicated loss; three steps with
density control stay finite.

This file is also the worker: `python test_torch_dist.py` with torchrun's
variables set runs one rank and writes its results as JSON.
"""
import json
import os
import socket
import subprocess
import sys

import pytest

WORLD = 2
BATCH = 4
STEPS = 3


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def worker(out_path: str) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from humangaussian_torch.dist.parallel import (
        make_dp_train_step,
        multihost_init,
    )
    from port_parity_torch import tiny_port_system

    torch.set_num_threads(1)
    assert multihost_init()
    assert dist.get_backend() == "gloo"
    system = tiny_port_system(seed=0, batch=BATCH)
    dp_step = make_dp_train_step(system)

    def fresh():
        return system.init_state(seed=7)

    s_ref, m_ref = system.train_step(fresh())
    s_dp, m_dp = dp_step(fresh())

    def diff(a, b):
        return float((a - b).abs().max())

    res = {
        "rank": dist.get_rank(), "world": dist.get_world_size(),
        "loss": float(m_dp["loss"]), "loss_ref": float(m_ref["loss"]),
        "loss_bits": np.float32(m_dp["loss"]).tobytes().hex(),
        "means": diff(s_dp.scene.means, s_ref.scene.means),
        "grad_accum": diff(s_dp.densify.grad_accum,
                           s_ref.densify.grad_accum),
        "radii_equal": bool(torch.equal(s_dp.densify.max_radii2d,
                                        s_ref.densify.max_radii2d)),
        "generator_equal": bool(torch.equal(s_dp.generator.get_state(),
                                            s_ref.generator.get_state())),
        "step": s_dp.step,
    }
    state = fresh()
    losses = []
    for _ in range(STEPS):
        state, metrics = dp_step(state)
        state, _ = system.maybe_densify(state)
        losses.append(float(metrics["loss"]))
    res.update(multi_losses=losses, multi_step=state.step,
               n_alive=int(state.scene.alive.sum()))
    with open(out_path, "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist")
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(here), here, env.get("PYTHONPATH", "")])
    env["CUDA_VISIBLE_DEVICES"] = ""  # gloo CPU ranks, also on a card
    procs, outs = [], []
    for rank in range(WORLD):
        out = str(tmp / f"rank{rank}.json")
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), out],
            env=dict(env, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                     WORLD_SIZE=str(WORLD), RANK=str(rank),
                     LOCAL_RANK=str(rank)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=110)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{log[-4000:]}"
    results = []
    for out in outs:
        with open(out) as f:
            results.append(json.load(f))
    return results


@pytest.mark.timeout(120)
def test_dp_step_matches_the_single_process_step(ranks):
    for r in ranks:
        assert r["world"] == WORLD and r["step"] == 1
        assert r["loss"] == pytest.approx(r["loss_ref"], rel=2e-4)
        assert r["means"] <= 1e-5, r
        assert r["grad_accum"] <= 1e-6, r
        assert r["radii_equal"], r
        assert r["generator_equal"], r


@pytest.mark.timeout(120)
def test_ranks_agree_bit_for_bit_and_densify_in_lock_step(ranks):
    assert {r["rank"] for r in ranks} == set(range(WORLD))
    assert len({r["loss_bits"] for r in ranks}) == 1, ranks
    assert len({tuple(r["multi_losses"]) for r in ranks}) == 1, ranks
    assert len({r["n_alive"] for r in ranks}) == 1, ranks
    for r in ranks:
        assert r["multi_step"] == STEPS
        assert all(map(lambda v: v == v and abs(v) < float("inf"),
                       r["multi_losses"]))


def test_multihost_init_is_a_no_op_without_torchrun(monkeypatch):
    import torch.distributed as dist

    from humangaussian_torch.dist.parallel import multihost_init

    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert multihost_init() is False
    assert not dist.is_initialized()


if __name__ == "__main__":
    worker(sys.argv[1])
