"""Multi-process data-parallel training on pydens_tpu_torch.

Scaling past one process is three lines of setup, not a different API:
every process joins the group (``parallel.distributed.initialize``),
builds the SAME solver over the global mesh (``make_mesh()``), and drives
it in lockstep.  Each rank draws the same full batch from the same seed
and keeps its slice; the loss and the gradient are summed over the ranks
in one all-reduce a step, inside the step's captured CUDA graph, so every
rank holds the same parameters.

On the card the demo runs one rank per CUDA card over NCCL (a card takes
one rank: NCCL refuses two on one GPU), so on a machine with one card it
is a group of one; with ``device='cpu'`` it spawns two gloo ranks.  The
ranks rendezvous on a free local port.  The port of examples/18.

From the repository root, on the CUDA card (``--cpu``: on the CPU)::

    PYTHONPATH=. python examples_torch/18_distributed_data_parallel.py [--cpu]
"""

import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

NITERS, BATCH = 200, 64


def worker(rank, world, port, out_path, device):
    """One training process: this function body (with the coordinator's
    address, the world size and the rank) IS the whole program."""
    from pydens_tpu_torch.parallel import distributed, make_mesh
    distributed.initialize(f"localhost:{port}", world, rank, device=device)

    from pydens_tpu_torch import Solver, D
    from pydens_tpu_torch.ops import fused_taylor

    def ode(f, x):
        return D(f, x) - 2 * np.pi * torch.cos(2 * np.pi * x)

    mesh = make_mesh(device=device)  # spans every rank of the group
    solver = Solver(ode, ndims=1, initial_condition=.5, mesh=mesh, seed=0,
                    activation="Tanh", layout="fafaf", features=[12, 10, 1],
                    device=device)
    t0 = time.perf_counter()
    solver.fit(niters=NITERS, batch_size=BATCH, lr=0.02, progress=False)
    seconds = time.perf_counter() - t0

    # Every rank holds the same parameters: predict anywhere.
    xs = np.linspace(0, 1, 50)
    err = float(np.max(np.abs(solver.predict(xs).ravel()
                              - (np.sin(2 * np.pi * xs) + .5))))
    if rank == 0:
        steps = list(solver._step_cache.values())
        with open(out_path, "w") as fh:
            json.dump({
                "final_loss": float(solver.losses[-1]), "err": err,
                "world": world, "backend": torch.distributed.get_backend(),
                "it_s": NITERS / seconds,
                # What the rank ran: fit steps taken eagerly or replayed
                # from a captured graph, and the Taylor kernels' launches
                # (an eager step or a capture each).
                "steps": {"eager": sum(s.eager_steps for s in steps),
                          "replays": sum(s.replays for s in steps),
                          "graphs": sum(s.graph is not None for s in steps)},
                "taylor_launches": {
                    "forward": fused_taylor.fused_taylor_forward.launches,
                    "backward": fused_taylor.fused_taylor_backward.launches},
            }, fh)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def _free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def main(device=None):
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "demo's two ranks on the CPU")
    world = 2 if cpu else torch.cuda.device_count()  # one rank per card
    port = _free_port()
    out = os.path.join(tempfile.mkdtemp(), "result.json")
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + (
        ":" + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", str(rank),
         str(world), str(port), out, "cpu" if cpu else "cuda"], env=env)
        for rank in range(world)]
    try:
        for p in procs:
            assert p.wait(timeout=420) == 0, "distributed worker failed"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    with open(out) as fh:
        result = json.load(fh)
    how = ("gloo ranks on the CPU" if cpu
           else "NCCL, one rank per CUDA card")
    print(f"{world}-process distributed fit ({how}): final loss "
          f"{result['final_loss']:.5f}, max |u - sin(2pi x) - 1/2| = "
          f"{result['err']:.4f}")
    assert result["final_loss"] < 5e-2, result
    assert result["err"] < 0.15, result
    return None, result


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5],
               sys.argv[6])
    else:
        main("cpu" if "--cpu" in sys.argv[1:] else None)
