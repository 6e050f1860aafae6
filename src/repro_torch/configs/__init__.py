"""The paper's own SVM experiment configurations (``svm_paper``)."""
