"""The serving step's batch over the data axis, the rank function
``tests/test_torch_mesh_rows.py`` spawns (no JAX here, so spawned ranks
import this module quickly).

``serve_job`` serves each run of the job on this rank through
``ServeEngine(mesh=...)`` (eager, the mesh step set) and returns, per
run, the rank's tokens, stats, qmm paths and collectives by kind (calls
over the run), and the rows of its arena's SSM and conv state.
"""
import copy
import dataclasses

import numpy as np
import torch

from repro_torch.kernels import ops as kops
from repro_torch.serve.engine import Request, ServeEngine

ENGINE = dict(slots=4, max_len=32, page_size=8, n_pages=15)


def requests(vocab: int, n: int = 6, seed: int = 5, max_new: int = 4,
             lengths=None):
    """``n`` prompts drawn with numpy (lengths 4-13, or ``lengths``)."""
    rng = np.random.default_rng(seed)
    if lengths is None:
        lengths = rng.integers(4, 14, size=n)
    return [Request(uid=i, prompt=rng.integers(2, vocab, size=int(n_tok))
                    .astype(np.int32), max_new_tokens=max_new)
            for i, n_tok in enumerate(lengths)]


def state_rows(arena) -> list:
    """The slot rows of every SSM and conv leaf of an arena."""
    return sorted({leaf.shape[1] for g in arena.values() if "mamba" in g
                   for leaf in g["mamba"].values()})


def serve_job(mesh, job):
    """Each run of ``job["runs"]`` (a model name of ``job["models"]``,
    engine keywords and requests) on this rank."""
    out = []
    for run in job["runs"]:
        model = job["models"][run["model"]]
        eng = ServeEngine(model["cfg"], model["params"], mesh=mesh,
                          cuda_graphs=False, device="cpu",
                          **run.get("engine", ENGINE))
        reqs = copy.deepcopy(run["requests"])
        kops.reset_path_counts()
        k0 = {k: v[0] for k, v in mesh.by_kind.items()}
        with torch.no_grad():
            eng.run(reqs)
        st = eng.stats
        out.append(dict(
            tokens=[r.out_tokens for r in reqs],
            stats={f.name: getattr(st, f.name)
                   for f in dataclasses.fields(st)
                   if isinstance(getattr(st, f.name), (int, float))},
            paths=dict(kops.path_counts),
            by_kind={k: v[0] - k0.get(k, 0) for k, v in mesh.by_kind.items()
                     if v[0] - k0.get(k, 0)},
            state_rows=state_rows(eng._arena),
            rows=eng.step_set.rows))
    return out
