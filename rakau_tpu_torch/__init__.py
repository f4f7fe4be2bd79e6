"""rakau_tpu_torch — the Barnes-Hut N-body engine of `rakau_tpu` on
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

Ported so far: the shared-candidate traversal with the "local", "m2p"
and "grid" far fields (monopole, fp32 accumulation), the Morton build,
the `Tree` `_u`/`_o` API with updates, and the direct-sum oracles. The
pairwise kernel runs as CUDA C++ on CUDA tensors and as plain PyTorch on
CPU tensors. Importing the package compiles nothing: the kernel is built
with nvcc at its first launch.
"""
from .config import MAC_BH, MAC_BH_GEOM, TreeConfig
from .direct import direct_acc_pot, direct_acc_pot_np
from .tree import Tree, octree, quadtree

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
