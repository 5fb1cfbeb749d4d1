"""Checkpoint / resume for the simulation loop.

The PyTorch package's copy of ``eddy_currents_3d_tpu/sim/checkpoint.py``,
in the same format, so a checkpoint written by either package resumes in
the other.  The reference has no restart capability (SURVEY §5); the
restartable state is exactly: the solution vector ``Uaf`` (A, U), the
inertial history ``Jaf`` (carry), per-function motion state (Distance +
the global movestop latch, and the distances' Kahan compensation), the
extrapolated warm start's previous solution, and the step/output
counters.  A checkpoint is one ``.npz`` with those arrays plus a config
fingerprint, so a resume against a different model fails loudly instead
of silently diverging.  Fields are stored as the host copies of the
tensors (bfloat16 widened to float32: exact); motion in host float64, as
:class:`~.motion.MotionState` keeps it.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch

from ..assembly.stencil import State
from ..utils.device import resolve_device
from .motion import MotionState
from .simulate import SimState

__all__ = ["save_checkpoint", "load_checkpoint", "model_fingerprint",
           "latest_checkpoint"]

_FORMAT = 1


def model_fingerprint(model) -> str:
    """Cheap structural hash of everything that must match across a
    resume; for the same model, the JAX package's digest."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(model.geo).tobytes())
    meta = {
        "shape": model.shape_xyz,
        "delta": [float(d) for d in model.delta],
        "dt": model.tran.step,
        "stop": model.tran.stop,
        "jump": model.tran.jump,
        "tol": model.solver.tolerance,
        "itmax": model.solver.itmax,
        "bound": model.solver.bound,
        "bnd": np.asarray(model.solver.BND).tolist(),
        "domains": [(d.ident, d.D, d.C, list(d.Ve)) for d in model.domains],
        "functions": [
            (f.name, f.direction, f.domain, f.expression.source,
             list(f.arg_names), [float(v) for v in f.arg_values],
             list(f.move), list(f.vmech_index), [float(v) for v in f.vmech_const])
            for f in model.functions
        ],
        "vmech": [(v.name, v.expression.source) for v in model.vmech],
    }
    h.update(json.dumps(meta, sort_keys=True).encode())
    return h.hexdigest()


def _host(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(t)


def save_checkpoint(path: str, state: SimState, step_index: int, npoint: int,
                    fingerprint: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    extra = {}
    if state.prev is not None:   # extrapolated-warm-start history
        extra = {"prevA": _host(state.prev.A), "prevU": _host(state.prev.U)}
    np.savez_compressed(
        tmp,
        format=np.int64(_FORMAT),
        A=_host(state.A),
        U=_host(state.U),
        carry=_host(state.carry),
        distance=np.asarray(state.motion.distance),
        movestop=np.asarray(state.motion.movestop),
        motion_comp=np.asarray(state.motion.comp),
        step_index=np.int64(step_index),
        npoint=np.int64(npoint),
        fingerprint=np.frombuffer(fingerprint.encode(), np.uint8),
        **extra,
    )
    # numpy appends .npz to the tmp name
    os.replace(tmp + ".npz", path)


def load_checkpoint(path: str, fingerprint: str, dtype=None, device=None):
    """Returns (SimState, step_index, npoint), the fields as tensors on
    ``device`` (default: the current CUDA device; pass ``device="cpu"``
    for the CPU) in ``dtype`` (default: as stored), the motion in host
    float64.  Raises on config mismatch."""
    device = resolve_device(device)
    z = np.load(path)
    if int(z["format"]) != _FORMAT:
        raise ValueError(f"unsupported checkpoint format {int(z['format'])}")
    stored = bytes(z["fingerprint"]).decode()
    if stored != fingerprint:
        raise ValueError(
            "checkpoint was written for a different model/config "
            f"(stored {stored[:12]}..., current {fingerprint[:12]}...)"
        )
    cast = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
        device=device, dtype=dtype)
    distance = np.asarray(z["distance"], np.float64)
    state = SimState(
        A=cast(z["A"]),
        U=cast(z["U"]),
        carry=cast(z["carry"]),
        motion=MotionState(
            distance=distance,
            movestop=np.asarray(z["movestop"], np.int32),
            # pre-Kahan checkpoints carry no compensation: resume with 0
            comp=(np.asarray(z["motion_comp"], np.float64)
                  if "motion_comp" in z.files else np.zeros_like(distance)),
        ),
        prev=(State(cast(z["prevA"]), cast(z["prevU"]))
              if "prevA" in z.files else None),
    )
    return state, int(z["step_index"]), int(z["npoint"])


def latest_checkpoint(directory: str):
    """Newest ckpt_<step>.npz in a directory, or None."""
    if not os.path.isdir(directory):
        return None
    best, best_step = None, -1
    for name in os.listdir(directory):
        if name.startswith("ckpt_") and name.endswith(".npz"):
            try:
                step = int(name[5:-4])
            except ValueError:
                continue
            if step > best_step:
                best, best_step = os.path.join(directory, name), step
    return best
