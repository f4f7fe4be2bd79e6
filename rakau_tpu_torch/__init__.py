"""rakau_tpu_torch — the Barnes-Hut N-body engine of `rakau_tpu` on
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

Ported so far: the shared-candidate and the lmac traversal with the
"local", "m2p", "grid" and "grid2" far fields, the gwalk traversal with
"m2p", "grid" and "grid2", and the per-tile lists traversal (the
reference's diagnostic mode); fp32 or compensated accumulation, the
quadrupole; 2-D and 3-D, float32 and float64 trees; the Morton build; the
`Tree` `_u`/`_o` API with updates; the leapfrog harness (`integrate`),
checkpoints, `metrics` and the direct-sum oracles. Entry points run on
the CUDA card unless given `device="cpu"`. The pairwise kernel (with its
tensor-core and split-source forms), the pool kernel and the tile-list
kernels run as CUDA C++ on CUDA tensors and as plain PyTorch on CPU
tensors. Importing the package compiles nothing: a kernel is built with
nvcc at its first launch.
"""
from .config import MAC_BH, MAC_BH_GEOM, TreeConfig
from .direct import direct_acc_pot, direct_acc_pot_np
from .tree import Tree, octree, quadtree
from . import checkpoint, integrate, metrics

__version__ = "0.1.0"

__all__ = [
    "TreeConfig",
    "MAC_BH",
    "MAC_BH_GEOM",
    "direct_acc_pot",
    "direct_acc_pot_np",
    "Tree",
    "octree",
    "quadtree",
]
