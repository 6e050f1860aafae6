"""PyTorch/CUDA port of the doubly distributed optimizers (``repro``).

Mirrors the layout of the JAX package module by module
(``repro_torch/core/d3ca.py`` is the counterpart of
``repro/core/d3ca.py``) and imports only ``torch`` and ``numpy``.

Two rules hold everywhere:

* **Device rule.**  Every entry point takes ``device=`` and defaults to
  ``"cuda"``.  Without a CUDA device it raises; it never carries on on
  the CPU by itself.  Pass ``device="cpu"`` to ask for the CPU.
* **Backend rule.**  ``local_backend="kernel"`` runs the hand-written
  CUDA kernels of ``repro_torch.kernels`` for tensors on a CUDA device
  and their plain PyTorch versions only for tensors that lie on the
  CPU; ``"ref"`` is the plain per-step loop of ``core/local.py`` and
  has to be asked for by name.
"""
