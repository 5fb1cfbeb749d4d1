"""eddy_currents_3d_tpu_torch — the 3D eddy-current framework in PyTorch.

The PyTorch and CUDA port of ``eddy_currents_3d_tpu``: the same `.vxc`
input, the same assembled operator, the same restarted BiCGSTAB and time
step, and the same legacy-VTK bytes, on one CUDA device (NVIDIA Hopper) or
on the CPU.  The modules mirror the JAX package's layout, so each
counterpart sits at the same path.  The float32 solve runs the case-coded
operator, or, for multigrid, bfloat16 coefficients and the models the
coded encoder refuses, the field tier (``ops/field.py``): on CUDA
hand-written kernels (``csrc/*.cu``), built with ``nvcc`` at first use; on
the CPU their plain torch versions.  This package never imports jax.
"""

__version__ = "0.1.0"

from .models.model import Model, DomainSpec, SolverConfig, TranConfig, SourceFunction
from .models.vxc import read_vxc
from .assembly.assemble import assemble_operator
from .assembly.stencil import State
from .ops.coded import CodedStencilOperator, CodedUnsupported, from_assembled_coded
from .ops.field import FieldStencilOperator
from .solvers.bicgstab import bicgstab_wr
from .solvers.multigrid import MgUnsupported, build_mg
from .sim.simulate import Simulation, SimState

__all__ = [
    "Model",
    "DomainSpec",
    "SolverConfig",
    "TranConfig",
    "SourceFunction",
    "read_vxc",
    "assemble_operator",
    "State",
    "CodedStencilOperator",
    "CodedUnsupported",
    "from_assembled_coded",
    "FieldStencilOperator",
    "MgUnsupported",
    "build_mg",
    "bicgstab_wr",
    "Simulation",
    "SimState",
    "__version__",
]
