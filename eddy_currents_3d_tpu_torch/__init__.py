"""eddy_currents_3d_tpu_torch — the 3D eddy-current framework in PyTorch.

The PyTorch and CUDA port of ``eddy_currents_3d_tpu``: the same `.vxc`
input, the same assembled operator, the same restarted BiCGSTAB and time
step, and the same legacy-VTK bytes, on one CUDA device (NVIDIA Hopper) or
on the CPU.  The modules mirror the JAX package's layout, so each
counterpart sits at the same path.  The float32 solve runs the case-coded
operator, or, for multigrid, bfloat16 coefficients and the models the
coded encoder refuses, the field tier (``ops/field.py``), which also
carries every bfloat16-state solve: on CUDA
hand-written kernels (``csrc/*.cu``), built with ``nvcc`` at first use; on
the CPU their plain torch versions.  ILU(0) factors the exported CSR
(``assembly.assemble.to_csr``) on the host (``csrc/ilu0_host.cpp``, built
with ``g++``).  The general sparse tier (``ops/sparse.py``) holds the
CSR/COO/ELL/BSR containers, with a hand-written block-sparse SpMM kernel
(``ops/bsr_cuda.py``).  Each solve runs as a device program
(``solvers/bicgstab.py`` ``DeviceLoop``; on the card CUDA graphs, the host
reading only ``(done, it)`` once per batch of iterations), under
``Simulation.run`` and ``run_scan``, with checkpoints in the JAX package's
format (``sim/checkpoint.py``).  This package never imports jax.
"""

__version__ = "0.1.0"

from .models.model import Model, DomainSpec, SolverConfig, TranConfig, SourceFunction
from .models.vxc import read_vxc
from .assembly.assemble import assemble_operator, to_csr
from .assembly.stencil import State
from .ops.coded import CodedStencilOperator, CodedUnsupported, from_assembled_coded
from .ops.field import FieldStencilOperator
from .ops.sparse import (BSRMatrix, COOMatrix, CSRMatrix, ELLMatrix,
                         bsr_from_scipy, from_scipy)
from .ops.bsr_cuda import bsr_matvec, bsr_spmm
from .solvers.bicgstab import (DeviceLoop, bicgstab_jacobi, bicgstab_wr,
                               bicgstab_wr_right)
from .solvers.ilu0 import ilu0_stencil_factorize
from .solvers.multigrid import MgUnsupported, build_mg
from .sim.simulate import Simulation, SimState, StepInfo
from .sim.checkpoint import (latest_checkpoint, load_checkpoint,
                             model_fingerprint, save_checkpoint)

__all__ = [
    "Model",
    "DomainSpec",
    "SolverConfig",
    "TranConfig",
    "SourceFunction",
    "read_vxc",
    "assemble_operator",
    "to_csr",
    "State",
    "CodedStencilOperator",
    "CodedUnsupported",
    "from_assembled_coded",
    "FieldStencilOperator",
    "COOMatrix",
    "CSRMatrix",
    "ELLMatrix",
    "BSRMatrix",
    "from_scipy",
    "bsr_from_scipy",
    "bsr_spmm",
    "bsr_matvec",
    "ilu0_stencil_factorize",
    "MgUnsupported",
    "build_mg",
    "bicgstab_wr",
    "bicgstab_wr_right",
    "bicgstab_jacobi",
    "DeviceLoop",
    "Simulation",
    "SimState",
    "StepInfo",
    "save_checkpoint",
    "load_checkpoint",
    "latest_checkpoint",
    "model_fingerprint",
    "__version__",
]
