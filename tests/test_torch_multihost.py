"""The port's multi-host bootstrap end to end: two real processes, each a
"host", join one gloo world through ``initialize_multihost()`` from the
``TPUSHARE_*`` env alone (as the multi-host demo pods do), build a
``dp=2`` or an ``fsdp=2`` mesh and train the decoder through
``run_train_loop``. The port's counterpart of tests/test_multihost.py
(whose two-process step is FSDP's).

The two-process run must give the one-process run's losses (rtol 1e-5:
the same f32 sums cut into two rank shares) and the same parameters
(atol 1e-5); only rank 0 writes checkpoints (whole, even at fsdp=2), both
ranks resume from the same one, and one process resumes from them too.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from gpushare_device_plugin_tpu_torch import const
from gpushare_device_plugin_tpu_torch.workloads import transformer as T
from gpushare_device_plugin_tpu_torch.workloads.optim import tree_leaves
from gpushare_device_plugin_tpu_torch.workloads.trainer import (
    DecoderTask,
    TrainLoopConfig,
    run_train_loop,
)

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64, max_seq=32)
BATCH, SEQ, STEPS = 4, 16, 3

WORKER = """
import json, sys, torch
from gpushare_device_plugin_tpu_torch.parallel.mesh import MeshSpec, make_mesh
from gpushare_device_plugin_tpu_torch.parallel.podenv import initialize_multihost
from gpushare_device_plugin_tpu_torch.workloads import transformer as T
from gpushare_device_plugin_tpu_torch.workloads.optim import tree_leaves
from gpushare_device_plugin_tpu_torch.workloads.trainer import (
    DecoderTask, TrainLoopConfig, run_train_loop)

torch.set_num_threads(1)
spec = initialize_multihost(backend="gloo", timeout_s=30)
mesh = make_mesh(MeshSpec(**json.loads(sys.argv[6])), device="cpu")
cfg = T.TransformerConfig(**json.loads(sys.argv[1]), compute_dtype=torch.float32)
task = DecoderTask(cfg, batch=int(sys.argv[2]), seq=int(sys.argv[3]))
losses = []
loop = lambda steps: run_train_loop(
    task, TrainLoopConfig(total_steps=steps, log_every=1, ckpt_dir=sys.argv[4], ckpt_every=1),
    0, mesh=mesh, on_metrics=lambda step, loss: losses.append(loss))
loop(2)  # two steps, checkpointed
state, _ = loop(int(sys.argv[5]))  # resumed from step 1
print("RESULT", json.dumps({
    "rank": spec.process_id, "losses": losses,
    "params": torch.cat([t.detach().reshape(-1) for t in tree_leaves(state[0])]).tolist(),
    "shapes": [list(t.shape) for t in tree_leaves(state[0])],
}), flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _two_processes(tmp_path, spec: dict) -> list[dict]:
    """Both processes' results of the worker on ``spec``'s mesh."""
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
        env.update({const.ENV_COORDINATOR_ADDRESS: f"127.0.0.1:{port}",
                    const.ENV_NUM_PROCESSES: "2", const.ENV_PROCESS_ID: str(pid)})
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER, json.dumps(CFG), str(BATCH), str(SEQ),
             str(tmp_path / "ckpt"), str(STEPS), json.dumps(spec)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    docs = []
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out[-3000:]}"
        docs.append(json.loads(out.split("RESULT ", 1)[1]))
    assert [d["rank"] for d in docs] == [0, 1]
    # One checkpoint per step (rank 0's), no temporary file left behind.
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "step_000000000.pt", "step_000000001.pt", "step_000000002.pt"]
    return docs


def _one_process(ckpt_dir=None):
    """The one-process run: its losses and its parameters, flat."""
    cfg = T.TransformerConfig(**CFG, compute_dtype=torch.float32)
    losses = []
    state, _ = run_train_loop(DecoderTask(cfg, batch=BATCH, seq=SEQ),
                              TrainLoopConfig(total_steps=STEPS, log_every=1,
                                              ckpt_dir=str(ckpt_dir or "")), 0, device="cpu",
                              on_metrics=lambda step, loss: losses.append(loss))
    return losses, torch.cat([t.detach().reshape(-1) for t in tree_leaves(state[0])]).numpy()


def test_two_process_dp_training_equals_one_process(tmp_path):
    docs = _two_processes(tmp_path, {"dp": 2})
    losses, want = _one_process()
    for d in docs:
        # steps 0 and 1, then step 2 after resuming from step 1's checkpoint
        np.testing.assert_allclose(d["losses"], losses, rtol=1e-5)
        np.testing.assert_allclose(d["params"], want, rtol=0, atol=1e-5)
    assert docs[0]["params"] == docs[1]["params"]


def test_two_process_fsdp_train_step(tmp_path):
    """fsdp=2: each process holds half of every weight cut on the model
    dim; gathered whole, the parameters are the one-process run's, and
    the whole checkpoints rank 0 wrote restore in one process."""
    docs = _two_processes(tmp_path, {"fsdp": 2})
    losses, want = _one_process()
    cfg = T.TransformerConfig(**CFG, compute_dtype=torch.float32)
    whole = [list(t.shape) for t in tree_leaves(T.init_params(cfg, torch.Generator().manual_seed(0),
                                                              device="cpu"))]
    for d in docs:
        np.testing.assert_allclose(d["losses"], losses, rtol=1e-5)
        # every leaf but the norms' gains (and the embedding's, on d) halves
        assert d["shapes"] != whole
        assert sum(np.prod(s) for s in d["shapes"]) < 0.6 * sum(np.prod(s) for s in whole)
    shards = [np.split(np.asarray(d["params"]), np.cumsum([np.prod(s) for s in d["shapes"]])[:-1])
              for d in docs]
    got = []
    for a, b, shape, full in zip(*shards, docs[0]["shapes"], whole):
        a, b = a.reshape(shape), b.reshape(shape)
        dim = next((i for i, (n, m) in enumerate(zip(shape, full)) if n != m), None)
        got.append(a if dim is None else np.concatenate([a, b], axis=dim))
    np.testing.assert_allclose(np.concatenate([g.reshape(-1) for g in got]), want,
                               rtol=0, atol=1e-5)
    # the fsdp=2 checkpoint of the last step is whole: one process loads it
    resumed_losses, resumed = _one_process(tmp_path / "ckpt")
    assert resumed_losses == []  # nothing left to run
    np.testing.assert_allclose(resumed, np.concatenate([g.reshape(-1) for g in got]),
                               rtol=0, atol=0)
