from .synthetic import make_sparse_svm_data, make_svm_data

__all__ = ["make_svm_data", "make_sparse_svm_data"]
