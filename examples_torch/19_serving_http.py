"""Serving a trained solution from a bare process — the deployment unit —
on pydens_tpu_torch.

``Solver.export()`` produces a self-contained ``torch.export`` artifact:
network parameters and V-variables baked in, the batch dimension dynamic.
The serving side needs torch only — not pydens_tpu_torch, not the Python
equation, not the training machinery.  This example closes the loop end
to end:

1. train a 2D Poisson solver (the reference's README workload),
2. export the field to bytes,
3. serve it over HTTP from a stdlib ``http.server`` in a separate process
   that imports torch and numpy alone (the package made unimportable),
4. query the server and check the answers against ``solver.predict``
   (the fused MLP kernel on the card; the artifact holds the plain
   forward).

The port of examples/19.

From the repository root, on the CUDA card (``--cpu``: on the CPU)::

    PYTHONPATH=. python examples_torch/19_serving_http.py [--cpu]
"""

import json
import os
import select
import socket
import subprocess
import sys
import tempfile
import time
import urllib.request

import numpy as np
import torch

# The server process: loads the artifact with bare torch.export and answers
# POST /predict with {"xs": [[...], ...]} -> {"u": [[...], ...]}.
# Deliberately framework-free: the deployment unit is the artifact.
_SERVER = r"""
import io, json, sys
from http.server import BaseHTTPRequestHandler, HTTPServer
for name in ("pydens_tpu_torch", "pydens_tpu", "jax"):
    sys.modules[name] = None            # the artifact must stand alone
import torch
from torch.export.passes import move_to_device_pass

artifact_path, port, device = sys.argv[1], int(sys.argv[2]), sys.argv[3]
with open(artifact_path, "rb") as fh:
    blob = fh.read()
MAGIC = b"PDTTORCHEXP1"                 # pydens_tpu_torch export framing
assert blob.startswith(MAGIC)
program = torch.export.load(io.BytesIO(blob[len(MAGIC):]))
fn = move_to_device_pass(program, device).module()

class Handler(BaseHTTPRequestHandler):
    def do_POST(self):
        n = int(self.headers["Content-Length"])
        xs = torch.tensor(json.loads(self.rfile.read(n))["xs"],
                          dtype=torch.float32, device=device)
        with torch.no_grad():
            u = fn(xs).cpu()            # dynamic batch: any size
        body = json.dumps({"u": u.tolist()}).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass

srv = HTTPServer(("127.0.0.1", port), Handler)
print("READY", flush=True)
srv.serve_forever()
"""
# A first load in a fresh process imports the export machinery: seconds.
READY_TIMEOUT = 300


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def main(device=None):
    from pydens_tpu_torch import Solver, D

    def pde(f, x, y):
        return D(D(f, x), x) + D(D(f, y), y) - 5 * torch.sin(np.pi * (x + y))

    solver = Solver(pde, ndims=2, boundary_condition=1, layout="fa fa fa f",
                    activation="Tanh", units=[10, 12, 15, 1], seed=0,
                    device=device)
    solver.fit(batch_size=100, niters=800, progress=False)

    tmp = tempfile.mkdtemp()
    artifact = os.path.join(tmp, "poisson.pdtx")
    solver.export(artifact)
    server_py = os.path.join(tmp, "server.py")
    with open(server_py, "w") as fh:
        fh.write(_SERVER)

    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen([sys.executable, server_py, artifact, str(port),
                             solver.device.type], env=env,
                            stdout=subprocess.PIPE, text=True)
    errs, ms = {}, {}
    try:
        ready, _, _ = select.select([proc.stdout], [], [], READY_TIMEOUT)
        assert ready and proc.stdout.readline().strip() == "READY", (
            "the server did not start")
        for n in (7, 33):               # two batch sizes: a dynamic batch
            xs = np.random.default_rng(n).uniform(0, 1, (n, 2))
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/predict",
                data=json.dumps({"xs": xs.tolist()}).encode(),
                headers={"Content-Type": "application/json"})
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=60) as resp:
                served = np.asarray(json.loads(resp.read())["u"])
            ms[n] = (time.perf_counter() - t0) * 1e3
            local = solver.predict(xs.astype(np.float32))
            errs[n] = float(np.max(np.abs(served - local)))
            print(f"batch {n}: served == predict to {errs[n]:.2e} "
                  f"({ms[n]:.0f} ms)")
            assert served.shape == (n, 1)
            assert errs[n] < 1e-5, errs[n]
    finally:
        proc.kill()
        proc.wait()
    print("served artifact matches the training-side solution")
    return solver, {f"err_n{n}": e for n, e in errs.items()} | {
        f"served_ms_n{n}": t for n, t in ms.items()}


if __name__ == "__main__":
    main("cpu" if "--cpu" in sys.argv[1:] else None)
