"""Checkpoint / resume.

The reference has no checkpointing (SURVEY.md section 5); its nearest
artifacts are writelp re-emission and .out files.  Here
solver state is a flat pytree of arrays, so persistence is a plain npz:

- save_solution / load_solution round-trip a Solution (the .out-equivalent
  machine-readable artifact);
- save_state / load_state persist an in-flight solver state pytree (e.g.
  an HsdState) so a long solve can resume — pass the loaded state back to
  the solver's while_loop driver.
"""

from __future__ import annotations

import numpy as np

from ..core.lp import Solution


def save_solution(path: str, sol: Solution) -> None:
    np.savez(
        path,
        status=np.int64(sol.status),
        x=sol.x, y=sol.y, w=sol.w, z=sol.z,
        primal_obj=np.float64(sol.primal_obj),
        dual_obj=np.float64(sol.dual_obj),
        iterations=np.int64(sol.iterations),
        b_canon=sol.b_canon if sol.b_canon is not None else np.zeros(0),
    )


def load_solution(path: str) -> Solution:
    d = np.load(path)
    b_canon = d["b_canon"]
    return Solution(
        status=int(d["status"]), x=d["x"], y=d["y"], w=d["w"], z=d["z"],
        primal_obj=float(d["primal_obj"]), dual_obj=float(d["dual_obj"]),
        iterations=int(d["iterations"]),
        b_canon=b_canon if b_canon.size else None,
    )


def save_state(path: str, state) -> None:
    """Persist any NamedTuple-of-arrays solver state."""
    np.savez(path, **{k: np.asarray(v) for k, v in state._asdict().items()})


def load_state(path: str, state_cls):
    d = np.load(path)
    return state_cls(**{k: d[k] for k in state_cls._fields})
