"""Ranks over gloo on the CPU for the port's data-parallel tests.

`launch("all", world, tmp, timeout)` starts ``world`` processes of this
file with torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` / ``MASTER_PORT`` on a free port), each of which joins the
group through `conductor_tpu_torch.parallel.init_from_env` and runs
``task`` on ``tmp/in.pt``, writing ``tmp/out<rank>.pt``.  Each process is
waited for with its own timeout and killed at it, so that a hang fails the
test.  "all" runs `attention_rows`, `run_case` for each case and
`evaluate_rows` on ``in.pt``'s inputs, "wave" `evaluate_wave`; these are
also what the one-process side of each comparison calls, with ``Mesh()``.
Imports torch and the port only.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np
import torch

from conductor_tpu_torch.parallel.mesh import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rank_env(rank: int, world: int, port: int) -> dict:
    return dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="2",
                PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))


def wait_all(procs: list[subprocess.Popen], timeout: float) -> list[str]:
    """Each process's output; kills them all and raises if one fails or
    outlasts ``timeout`` seconds (counted from the call)."""
    deadline = time.time() + timeout
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.time()))
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    bad = [(i, p.returncode) for i, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise AssertionError(f"ranks failed {bad}:\n" + "\n".join(o[-3000:] for o in outs))
    return outs


def launch(task: str, world: int, tmp: str, timeout: float = 240.0) -> list[dict]:
    """Run ``task`` on ``world`` ranks over gloo; returns each rank's output."""
    port = free_port()
    procs = [subprocess.Popen([sys.executable, __file__, task, tmp], env=rank_env(r, world, port),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              cwd=REPO)
             for r in range(world)]
    wait_all(procs, timeout)
    return [torch.load(os.path.join(tmp, f"out{r}.pt"), weights_only=False) for r in range(world)]


# ----------------------------------------------------------------- the tasks


def make_trainer(case: dict, mesh=None):
    from conductor_tpu_torch import DDPMTrainer
    from conductor_tpu_torch.interop import synthetic_motion_encoder_state_dict, synthetic_state_dict

    tr = DDPMTrainer(case["cfg"], device="cpu", mesh=mesh)
    tr.load_reference_state_dict(synthetic_state_dict(tr.model, seed=1),
                                 motion_encoder=synthetic_motion_encoder_state_dict(tr.feat_model,
                                                                                    seed=2))
    return tr


def run_case(case: dict, mesh=None) -> dict:
    """``case["steps"]`` steps of a trainer built from ``case["cfg"]`` on
    the global batch (``feats``, ``motion``, ``m_lens``), this rank's rows
    on ``mesh``; each step's random numbers are ``case["drawn"][i]`` (the
    global batch's) or drawn by the trainer where None.  Returns each
    step's metrics and summed gradients, the final parameters and the
    sampler's state."""
    from conductor_tpu_torch.parallel import Mesh

    mesh = mesh or Mesh()
    tr = make_trainer(case, mesh)
    grads: list[list[torch.Tensor]] = []
    step = tr.optimizer.step

    def capture(reduce=None):
        def red(gs):
            if reduce is not None:
                reduce(gs)
            grads.append([g.detach().clone() for g in gs])
        return step(reduce=red)

    tr.optimizer.step = capture
    rows = lambda a: None if a is None else torch.as_tensor(mesh.local(a))  # noqa: E731
    metrics = []
    for i in range(case["steps"]):
        drawn = case["drawn"][i] if case.get("drawn") else {}
        m = tr.train_step(rows(case["feats"]), rows(case["motion"]), rows(case.get("m_lens")),
                          **drawn)
        metrics.append({k: float(v) for k, v in m.items()})
    state = tr.sampler_state._asdict() if tr.sampler_state is not None else None
    return {"metrics": metrics, "grads": [[g.numpy() for g in gs] for gs in grads],
            "params": {k: v.detach().numpy().copy() for k, v in tr.model.state_dict().items()},
            "sampler": state}


def attention_rows(inp: dict, mesh) -> dict:
    """`cp_linear_attention` on this rank's time shard of q, k, v (and the
    mask): the output rows and the gradients of sum(out * cot) for q, k, v."""
    from conductor_tpu_torch.parallel import cp_linear_attention

    t = inp["q"].shape[1] // mesh.size
    sl = slice(mesh.rank * t, (mesh.rank + 1) * t)
    out = {}
    for name, mask in (("mask", inp["mask"]), ("nomask", None)):
        q, k, v = (torch.tensor(inp[x][:, sl], requires_grad=True) for x in "qkv")
        m = None if mask is None else torch.tensor(mask[:, sl])
        y = cp_linear_attention(q, k, v, inp["heads"], m)
        (y * torch.tensor(inp["cot"][:, sl])).sum().backward()
        out[name] = {"y": y.detach().numpy(), "dq": q.grad.numpy(), "dk": k.grad.numpy(),
                     "dv": v.grad.numpy()}
    return out


def evaluate_rows(inp: dict, mesh=None) -> dict:
    """`DiffusionEvaluator` over ``inp["root"]``'s test split in waves of
    ``inp["wave"]`` clips; rank 0's report and generated motion."""
    from conductor_tpu_torch.eval import DiffusionEvaluator

    tr = make_trainer(inp, mesh)
    ev = DiffusionEvaluator(tr, batch_size=inp["wave"], mesh=mesh)
    res = ev.evaluate(inp["root"], num_steps=inp["num_steps"], compute_beats=False)
    if res is None:
        return {"report": None}
    return {"report": res.as_dict(), "generated": ev.generated, "wave": ev.batch_size}


def evaluate_wave(inp: dict, mesh=None) -> dict:
    """`evaluate_rows` with every ``torch.matmul`` summing its K axis in
    parts whose count follows its row count (as a GEMM library picks its
    kernel, and with it the summation order, by the shape); also returns
    each call's row count."""
    real, rows = torch.matmul, []

    def matmul(a, b):
        m = a.numel() // a.shape[-1]
        rows.append(m)
        parts = [real(x, y) for x, y in zip(a.tensor_split(1 + (m // 60) % 4, -1),
                                            b.tensor_split(1 + (m // 60) % 4, -2))]
        return sum(parts[1:], parts[0])

    torch.matmul = matmul
    try:
        out = evaluate_rows(inp, mesh)
    finally:
        torch.matmul = real
    return dict(out, matmul_rows=rows)


def main(task: str, tmp: str) -> None:
    from conductor_tpu_torch.parallel import init_from_env, shutdown

    torch.set_num_threads(2)
    mesh, _ = init_from_env("gloo", "cpu")
    inp = torch.load(os.path.join(tmp, "in.pt"), weights_only=False)
    if task == "all":
        out = {"attention": attention_rows(inp["attention"], mesh),
               "cases": {name: run_case(case, mesh) for name, case in inp["cases"].items()},
               "eval": evaluate_rows(inp["evaluate"], mesh)}
    elif task == "wave":
        out = {"eval": evaluate_wave(inp["evaluate"], mesh)}
    else:
        raise SystemExit(f"unknown task {task}")
    torch.save(out, os.path.join(tmp, f"out{mesh.rank}.pt"))
    shutdown(mesh)


if __name__ == "__main__":
    np.seterr(all="ignore")
    main(sys.argv[1], sys.argv[2])
