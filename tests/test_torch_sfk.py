"""SFK of the port on the grid engine vs the reference's
``engine="simulated"``, per iteration, dense and sparse, with the
reference's row samples, permutations and minibatch orders injected; the
fourth index-source stream; sparse == dense inside the port (CPU)."""
import numpy as np
import pytest
import torch

from repro.core import SFKConfig as JSFK
from repro.core import get_solver as j_get_solver
from repro.data import csr_from_dense as j_csr_from_dense
from repro_torch.core import (ArrayIndexSource, GeneratorIndexSource,
                              SFKConfig, get_solver, partition)
from repro_torch.core.sfk import sfk_simulated, sfk_simulated_program
from repro_torch.core.losses import get_loss
from repro_torch.data import csr_from_dense, make_sparse_svm_data
from test_torch_common import (ITERS, P, Q, TOL, collect, compare,
                               make_problem, sfk_source)


def _problems():
    X, y = make_sparse_svm_data(120, 41, density=0.15, seed=7)
    X[:, 24:] = 0.0                      # the reference's edge instance
    Xd, yd = make_problem(200, 60, seed=2)
    Xo, yo = make_problem(101, 37, seed=2)
    return {"edge": (X, y, (4, 2)), "dense200": (Xd, yd, (3, 2)),
            "odd101": (Xo, yo, (3, 2))}


@pytest.mark.parametrize("inst", ["edge", "dense200", "odd101"])
@pytest.mark.parametrize("block_format", ["dense", "sparse"])
@pytest.mark.parametrize("loss,backend", [("hinge", "kernel"),
                                          ("hinge", "ref"),
                                          ("squared", "kernel")])
def test_sfk_matches_reference(inst, block_format, loss, backend):
    X, y, grid = _problems()[inst]
    # eta * 2 ||x_j||^2 < 2 keeps the squared-loss SGD steps contractive
    gamma = 0.01 if loss == "squared" else 0.05
    kw = dict(lam=0.05, outer_iters=ITERS, gamma=gamma, sample_frac=0.6,
              seed=4)
    sparse = block_format == "sparse"
    res_j, its_j = collect(
        j_get_solver("sfk")(engine="simulated", local_backend="ref",
                            block_format=block_format),
        loss, j_csr_from_dense(X) if sparse else X, y, JSFK(**kw), grid=grid)
    res_t, its_t = collect(
        get_solver("sfk")(device="cpu", local_backend=backend,
                          block_format=block_format,
                          index_source=sfk_source(4, len(y), 0.6,
                                                  grid=grid)),
        loss, csr_from_dense(X) if sparse else X, y, SFKConfig(**kw),
        grid=grid)
    compare(res_t, its_t, res_j, its_j, dual=False)
    assert (res_t.solver, res_t.block_format, res_t.alpha) == (
        "sfk", block_format, None)


def test_sfk_sparse_matches_dense_in_the_port():
    X, y, grid = _problems()["edge"]
    cfg = SFKConfig(lam=1.0, gamma=0.03, outer_iters=3, L=12)
    base = get_solver("sfk")(device="cpu").solve(
        "hinge", X, y, P=grid[0], Q=grid[1], cfg=cfg, record_history=False)
    for backend in ("kernel", "ref"):
        rs = get_solver("sfk")(device="cpu", local_backend=backend,
                               block_format="sparse").solve(
            "hinge", csr_from_dense(X), y, P=grid[0], Q=grid[1], cfg=cfg,
            record_history=False)
        np.testing.assert_allclose(rs.w.numpy(), base.w.numpy(), rtol=2e-4,
                                   atol=2e-4)


def test_sfk_eta_and_sample_frac_follow_the_reference():
    for t in (1, 2, 5, 17):
        cfg_t, cfg_j = SFKConfig(gamma=0.3), JSFK(gamma=0.3)
        assert cfg_t.eta(t) == float(np.float32(cfg_j.eta(t)))
    for bad in (0.0, 1.5, -0.1):
        with pytest.raises(ValueError, match="sample_frac"):
            SFKConfig(sample_frac=bad)
    # sample_frac = 1 samples every row: the scheme is then RADiSA's
    # block variant with mu over every row
    X, y = make_problem(200, 60, seed=3)
    from repro_torch.core import RADiSAConfig
    src = sfk_source(2, 200, 1.0, iters=2)
    assert all(np.all(src.sfk_sample(t).numpy() == 1.0) for t in (1, 2))
    w_s = get_solver("sfk")(device="cpu", index_source=src).solve(
        "hinge", X, y, P=P, Q=Q, cfg=SFKConfig(lam=0.05, gamma=0.05,
                                               sample_frac=1.0,
                                               outer_iters=2)).w
    w_r = get_solver("radisa")(device="cpu", index_source=src).solve(
        "hinge", X, y, P=P, Q=Q, cfg=RADiSAConfig(lam=0.05, gamma=0.05,
                                                  outer_iters=2)).w
    np.testing.assert_allclose(w_s.numpy(), w_r.numpy(), **TOL)


def test_sfk_sample_stream_is_new_and_leaves_the_others_alone():
    src = GeneratorIndexSource(5, P=3, Q=2, n_p=400, sample_frac=0.25,
                               device="cpu")
    s1 = src.sfk_sample(1)
    assert s1.shape == (3, 400) and s1.dtype == torch.float32
    assert set(torch.unique(s1).tolist()) <= {0.0, 1.0}
    assert 0.15 < float(s1.mean()) < 0.35
    assert torch.equal(src.sfk_sample(1), s1)
    assert not torch.equal(src.sfk_sample(2), s1)
    # the D3CA / RADiSA draws keep the seeds they had: (seed, t, stream)
    gen = torch.Generator().manual_seed((5 * 1_000_003 + 1) * 4 + 0)
    assert torch.equal(src.sdca_rows(1), torch.randint(
        0, 400, (3, 400), generator=gen, dtype=torch.int32))
    gen = torch.Generator().manual_seed((5 * 1_000_003 + 1) * 4 + 2)
    assert torch.equal(src.radisa_perm(1), torch.randperm(3, generator=gen))
    arr = ArrayIndexSource(sample={1: s1.numpy()}, device="cpu")
    assert torch.equal(arr.sfk_sample(1), s1)
    with pytest.raises(KeyError, match="sfk_sample"):
        ArrayIndexSource(device="cpu").sfk_sample(1)


def test_sfk_default_source_reproducible_and_descends():
    X, y = make_problem(200, 60, seed=9)
    cfg = SFKConfig(lam=0.05, gamma=0.05, outer_iters=4, seed=11)
    runs = [get_solver("sfk")(device="cpu").solve("hinge", X, y, P=P, Q=Q,
                                                  cfg=cfg)
            for _ in range(2)]
    assert torch.equal(runs[0].w, runs[1].w)
    h = runs[0].history
    assert h[3]["objective"] < h[0]["objective"]
    other = get_solver("sfk")(device="cpu").solve(
        "hinge", X, y, P=P, Q=Q, cfg=SFKConfig(lam=0.05, gamma=0.05,
                                               outer_iters=4, seed=12))
    assert not torch.equal(runs[0].w, other.w)


def test_sfk_simulated_wrapper_and_subblock_check():
    X, y = make_problem(101, 37, seed=10)
    cfg = SFKConfig(lam=0.05, outer_iters=2, gamma=0.05, seed=4)
    data = partition(X, y, P, Q, device="cpu")            # m_q = 19, P = 3
    with pytest.raises(ValueError, match="does not divide m_q"):
        sfk_simulated_program(get_loss("hinge"), data, cfg)
    padded = partition(X, y, P, Q, m_multiple=P * Q, device="cpu")
    seen = []
    src = sfk_source(4, 101, 0.5, iters=2)
    w = sfk_simulated("hinge", padded, cfg,
                      callback=lambda t, w: seen.append(t), index_source=src)
    assert seen == [1, 2] and w.shape == (37,)
    res = get_solver("sfk")(device="cpu", index_source=src).solve(
        "hinge", X, y, P=P, Q=Q, cfg=cfg)
    np.testing.assert_allclose(w.numpy(), res.w.numpy(), **TOL)
