from .sparse_io import MemoryBackend, SparseBackend, ZarrBackend, open_sparse_matrix
from .vec import SparseIoVec
