"""The paper's own experiment configurations (§IV).

Part 1: dense synthetic SVM instances with 2,000 x 3,000 blocks at
(P,Q) in {(4,2), (5,3), (7,4)}.  Part 2: strong scaling on realsim/news20
-shaped data; weak scaling with 40,000 x 5,000 blocks.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class SVMExperiment:
    name: str
    P: int
    Q: int
    block_n: int
    block_m: int
    lam: float
    loss: str = "hinge"
    sparsity: float = 1.0     # fraction of nonzeros (1.0 = dense)

    @property
    def n(self):
        return self.P * self.block_n

    @property
    def m(self):
        return self.Q * self.block_m


# Paper Table I (scaled down ~1/10 per side for CPU benchmarking; the
# benchmark harness also accepts --full for the paper-sized instances).
PART1 = [
    SVMExperiment("4x2", 4, 2, 2000, 3000, 1e-2),
    SVMExperiment("5x3", 5, 3, 2000, 3000, 1e-2),
    SVMExperiment("7x4", 7, 4, 2000, 3000, 1e-2),
]

# strong scaling partition ladders (paper Fig. 5)
STRONG_CONFIGS = [(1, 1), (2, 1), (1, 2), (4, 1), (2, 2), (1, 4),
                  (8, 1), (4, 2), (2, 4), (1, 8)]

# weak scaling (paper Fig. 6): block 40k x 5k, P in 1..7, Q in {2,3,4}
WEAK_P = list(range(1, 8))
WEAK_Q = [2, 3, 4]
WEAK_SPARSITY = [0.01, 0.05]

# Part 2 real datasets (paper §IV): shapes and densities of the LIBSVM
# files.  ``synthetic_profile`` gives the per-block numbers the fig6
# harness uses to run a paper-scale synthetic stand-in when the real
# file is absent -- at these densities the sparse (padded-ELL) block
# format is mandatory: a dense news20 block grid would need ~100 GB.
REAL_DATASETS = {
    # news20.binary: 19,996 x 1,355,191 at ~0.034% density (~9.1M nnz)
    "news20": {"n": 19996, "m": 1355191, "density": 3.4e-4, "lam": 1e-4},
    # real-sim: 72,309 x 20,958 at ~0.24% density (~3.7M nnz)
    "realsim": {"n": 72309, "m": 20958, "density": 2.4e-3, "lam": 1e-4},
}


def synthetic_profile(name: str, max_p: int, Q: int):
    """Per-block (block_n, block_m, density) for a weak-scaling run whose
    LARGEST grid (P=max_p, given Q) reaches the real dataset's size."""
    d = REAL_DATASETS[name]
    return d["n"] // max_p, d["m"] // Q, d["density"]
