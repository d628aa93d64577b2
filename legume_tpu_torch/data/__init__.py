from .sparse_io import (
    H5Backend,
    MemoryBackend,
    SparseBackend,
    ZarrBackend,
    create_sparse_from_csc,
    open_sparse_matrix,
)
from .vec import SparseIoVec
