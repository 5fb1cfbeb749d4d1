"""The benchmark's plain reference, in float64 on the host: the case as
data (``case.py``), the system matrix row by row as EC3D.f90 assembles it
(``system.py``), the moving coil's relocation voxel by voxel
(``motion.py``) and the step's semantics (``step.py``).  It reads no
``.vxc`` text and imports numpy, scipy and nothing of the program."""
