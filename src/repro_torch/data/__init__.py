from .libsvm import load_libsvm, load_libsvm_csr, save_libsvm
from .sparse import CSRMatrix, csr_from_dense, make_sparse_svm_csr
from .synthetic import make_sparse_svm_data, make_svm_data
from .tokens import (TokenPipeline, shard_batch, synthetic_lm_batch,
                     synthetic_token_batch)

__all__ = ["make_svm_data", "make_sparse_svm_data", "CSRMatrix",
           "csr_from_dense", "make_sparse_svm_csr", "load_libsvm",
           "load_libsvm_csr", "save_libsvm", "TokenPipeline",
           "shard_batch", "synthetic_lm_batch", "synthetic_token_batch"]
