"""The port's ADMM (the paper's block-splitting baseline) on the grid
engine against the reference's ``admm_simulated``, dense and sparse,
for the three losses, per iteration (CPU).  ADMM draws no indices, so
the two sides see the same arrays and nothing else."""
import numpy as np
import pytest
import torch

from repro.core import ADMMConfig as JADMM
from repro.core import admm_setup_simulated as j_admm_setup
from repro.core import admm_simulated as j_admm_simulated
from repro.core import get_solver as j_get_solver
from repro.core import partition as j_partition
from repro.core import partition_sparse as j_partition_sparse
from repro.core.admm import prox_loss as j_prox_loss
from repro_torch.core import get_solver, partition, partition_sparse
from repro_torch.core.admm import (ADMMConfig, admm_setup_simulated,
                                   admm_simulated, prox_loss)
from repro_torch.launch import optimize
from repro_torch.launch.mesh import close_grids, process_grid
from test_torch_common import (MESH_GRID_TIMEOUT, bounded,  # noqa: F401
                               make_problem)

#: end-to-end iterates vs the reference, as the port's other solver tests
TOL = dict(rtol=1e-5, atol=1e-5)
P, Q, N, M = 3, 2, 96, 40
LOSSES = ["hinge", "squared", "logistic"]


pytestmark = pytest.mark.usefixtures("bounded")


@pytest.fixture(scope="module", autouse=True)
def _process_grid():
    """The mesh cases of this module run on the memoized CPU process grid
    of 3 x 2 ranks, started here with the short MESH_GRID_TIMEOUT; its
    ranks stop when the module ends."""
    process_grid(3, 2, device="cpu", timeout=MESH_GRID_TIMEOUT)
    yield
    close_grids()


def _data(sparse, seed=5):
    X, y = make_problem(N, M, seed=seed)
    if sparse:
        X = X * (np.random.default_rng(seed).random(X.shape) < 0.3)
        return (X, y, j_partition_sparse(X, y, P, Q, m_multiple=P * Q),
                partition_sparse(X, y, P, Q, m_multiple=P * Q,
                                 device="cpu"))
    return (X, y, j_partition(X, y, P, Q, m_multiple=P * Q),
            partition(X, y, P, Q, m_multiple=P * Q, device="cpu"))


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("c", [0.3, 2.5])
def test_prox_matches_reference(loss, c):
    rng = np.random.default_rng(1)
    v = rng.normal(size=64).astype(np.float32) * 2
    y = np.where(rng.random(64) < 0.5, -1.0, 1.0).astype(np.float32)
    want = np.asarray(j_prox_loss(loss, v, y, np.float32(c)))
    got = prox_loss(loss, torch.from_numpy(v), torch.from_numpy(y), c)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        prox_loss("nope", torch.from_numpy(v), torch.from_numpy(y), c)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_cholesky_factor_matches_reference(sparse):
    _, _, J, T = _data(sparse)
    cfg = dict(lam=0.05, rho=0.05)
    Lj = np.asarray(j_admm_setup(J, JADMM(**cfg)))       # upper: M = U^T U
    Lt = admm_setup_simulated(T, ADMMConfig(**cfg))      # lower: M = L L^T
    np.testing.assert_allclose(Lt.numpy(), np.swapaxes(Lj, 1, 2),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("loss", LOSSES)
def test_admm_matches_reference(sparse, loss):
    _, _, J, T = _data(sparse)
    kw = dict(lam=0.05, rho=0.05, outer_iters=6)
    its_j, its_t = [], []
    j_admm_simulated(loss, J, JADMM(**kw),
                     callback=lambda t, w: its_j.append(np.asarray(w)))
    w_t = admm_simulated(loss, T, ADMMConfig(**kw),
                         callback=lambda t, w: its_t.append(w.numpy().copy()))
    assert len(its_t) == len(its_j) == 6
    for a, b in zip(its_t, its_j):
        np.testing.assert_allclose(a, b, **TOL)
    assert w_t.shape == (M,)


@pytest.mark.parametrize("block_format", ["dense", "sparse"])
@pytest.mark.parametrize("backend", ["kernel", "ref"])
def test_admm_solver_matches_reference(block_format, backend):
    X, y = make_problem(N, M, seed=8)
    if block_format == "sparse":
        X = X * (np.random.default_rng(8).random(X.shape) < 0.3)
    kw = dict(lam=0.1, rho=0.1, outer_iters=4)
    res_j = j_get_solver("admm")(engine="simulated",
                                 block_format=block_format).solve(
        "hinge", X, y, P=P, Q=Q, cfg=JADMM(**kw))
    # the local backend is accepted and ignored: ADMM's inner solve is
    # the cached Cholesky factor
    res_t = get_solver("admm")(local_backend=backend, device="cpu",
                               block_format=block_format).solve(
        "hinge", X, y, P=P, Q=Q, cfg=ADMMConfig(**kw))
    np.testing.assert_allclose(res_t.w.numpy(), np.asarray(res_j.w), **TOL)
    assert res_t.alpha is None and res_t.iters == 4
    for h_t, h_j in zip(res_t.history, res_j.history):
        np.testing.assert_allclose(h_t["objective"], h_j["objective"],
                                   rtol=1e-6)
    assert (res_t.solver, res_t.local_backend, res_t.block_format) == \
        ("admm", backend, block_format)
    # warm start from the reference's result continues as the reference
    cont_j = j_get_solver("admm")(engine="simulated",
                                  block_format=block_format).solve(
        "hinge", X, y, P=P, Q=Q, cfg=JADMM(**kw), warm_start=res_j)
    cont_t = get_solver("admm")(device="cpu",
                                block_format=block_format).solve(
        "hinge", X, y, P=P, Q=Q, cfg=ADMMConfig(**kw),
        warm_start=np.asarray(res_j.w))
    np.testing.assert_allclose(cont_t.w.numpy(), np.asarray(cont_j.w), **TOL)


def test_admm_knobs_and_registry():
    assert get_solver("admm").config_cls is ADMMConfig
    # the comm policies are ported: ADMM takes them as every solver does
    s = get_solver("admm")(device="cpu", compression="int8",
                           topology="pods=2")
    assert (s.compression_spec, s.topology_spec) == ("int8",
                                                     "pods=2:identity:ring")
    # the mesh engines are ported: ADMM runs on a CPU process grid, its
    # column Gram summed over the grid's columns, within 1e-5 of the grid
    # engine
    X, y = make_problem(60, 20, seed=5)
    cfg = ADMMConfig(lam=0.1, rho=0.1, outer_iters=3)
    mesh = get_solver("admm")(engine="shard_map", device="cpu").solve(
        "hinge", X, y, P=3, Q=2, cfg=cfg)
    flat = get_solver("admm")(device="cpu").solve("hinge", X, y, P=3, Q=2,
                                                  cfg=cfg)
    assert mesh.engine == "shard_map"
    np.testing.assert_allclose(mesh.w.numpy(), flat.w.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_admm_cli_on_the_cpu(capsys):
    summary = optimize.main(["--solver", "admm", "--mesh", "3x2", "--n",
                             "120", "--m", "36", "--lam", "0.1", "--iters",
                             "4", "--ref-epochs", "30", "--device", "cpu"])
    assert summary["solver"] == "admm" and summary["iters"] == 4
    assert summary["device"] == "cpu" and summary["rel_opt"] is not None
    out = capsys.readouterr().out
    objs = [float(line.split("f=")[1].split()[0])
            for line in out.splitlines() if line.strip().startswith("t=")]
    assert len(objs) == 4 and objs[-1] < objs[0]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            optimize.main(["--solver", "admm", "--mesh", "2x2", "--n", "40",
                           "--m", "12", "--iters", "1"])
