"""skirt_tpu — a batched Monte Carlo dust radiative transfer framework in JAX.

A from-scratch JAX/XLA re-design with the capabilities of the
reference C++/Qt/MPI code (SKIRT v7.3): batched photon-packet lifecycle
megakernels, grid-traversal kernels over Cartesian / tree / Voronoi dust
grids, segment-sum tallies, and pjit/shard_map multi-device scaling.

Internal conventions:
- All physics in SI units (m, kg, s, W); `skirt_tpu.units` converts at I/O.
- Device compute defaults to float32 with positions expressed in *model
  units* (scaled by the grid bounding box) for precision; tallies are
  accumulated in float64 on the host across launch batches.
- Randomness is counter-based (threefry) with a fixed seeding discipline
  (`skirt_tpu.rng`), replacing the reference's per-thread Mersenne Twister.
"""

__version__ = "0.1.0"

import os

# Path to the reference resource data tables (SED/dust-mix/grain data).
# Overridable via the SKIRT_TPU_DAT environment variable.
DATA_DIR = os.environ.get("SKIRT_TPU_DAT", "/root/reference/dat")

from . import constants  # noqa: E402,F401
from .units import Units, parse_quantity  # noqa: E402,F401
from .wavelengths import (  # noqa: E402,F401
    OligoWavelengthGrid,
    LogWavelengthGrid,
    NestedLogWavelengthGrid,
    FileWavelengthGrid,
)
