"""Mesh extraction, repair and I/O (replaces the reference's skimage
marching-cubes + trimesh stack)."""
from bundlesdf_tpu_torch.mesh.core import Mesh
from bundlesdf_tpu_torch.mesh.marching import marching_tetrahedra
