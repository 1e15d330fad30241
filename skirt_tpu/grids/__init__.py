"""Spatial dust grids and their batched traversal kernels.

ref: SKIRTcore/DustGrid.hpp:22-131 and the grid cluster (§2.6 of SURVEY.md):
Cartesian/cylindrical/spherical structured grids, octree/bintree adaptive
trees, and Voronoi unstructured grids.  Each grid exposes a uniform
device-side protocol consumed by the traversal engine:

- ``locate(pos) -> int32``: flat cell index containing pos, -1 outside.
- ``step(state, direction) -> (ds, state')``: distance to the exit of the
  current cell along direction and the successor traversal state.  The
  traversal state is a grid-specific NamedTuple carrying at least ``cell``
  (current flat index, -1 when outside) so the engine stays grid-agnostic.
- ``enter(pos, direction) -> (s0, state)``: advance a ray from outside to
  the domain boundary (ref: DustGrid::path's moveInside) returning the
  distance to entry and the initial traversal state.

Grid construction is host-side NumPy/C++ (mirroring the reference, where
tree/Voronoi construction is setup-time), frozen into device arrays.
"""

from .mesh import LinMesh, LogMesh, PowMesh, SymPowMesh
from .cartesian import CartesianGrid, TwoPhaseGrid

__all__ = [
    "LinMesh", "LogMesh", "PowMesh", "SymPowMesh",
    "CartesianGrid", "TwoPhaseGrid",
]

# grids implemented incrementally; import lazily so partial builds work
try:  # noqa: SIM105
    from .cylinder2d import Cylinder2DGrid  # noqa: F401
    __all__.append("Cylinder2DGrid")
except ImportError:
    pass
try:
    from .sphere1d import Sphere1DGrid  # noqa: F401
    __all__.append("Sphere1DGrid")
except ImportError:
    pass
try:
    from .sphere2d import Sphere2DGrid  # noqa: F401
    __all__.append("Sphere2DGrid")
except ImportError:
    pass
try:
    from .octree import OctreeGrid, BinTreeGrid, ParticleTreeGrid  # noqa: F401
    __all__ += ["OctreeGrid", "BinTreeGrid", "ParticleTreeGrid"]
except ImportError:
    pass
try:
    from .voronoi import VoronoiGrid  # noqa: F401
    __all__.append("VoronoiGrid")
except ImportError:
    pass
try:
    from .adaptivemesh import AdaptiveMeshGrid  # noqa: F401
    __all__.append("AdaptiveMeshGrid")
except ImportError:
    pass
