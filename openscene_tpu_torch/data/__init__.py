from .quantize import fnv_hash_vec, ravel_hash_vec, sparse_quantize
from .voxelizer import Voxelizer
