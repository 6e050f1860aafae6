"""RADiSA of the port on the grid engine vs the reference's
``engine="simulated"``, per iteration, with the reference's permutation
and minibatch streams injected (CPU)."""
import numpy as np
import pytest

from repro.core import RADiSAConfig as JRADiSA
from repro.core import get_solver as j_get_solver
from repro_torch.core import RADiSAConfig, get_solver, partition
from repro_torch.core.radisa import radisa_simulated
from test_torch_common import (ITERS, P, Q, SIZES, TOL, collect, compare,
                               make_problem, radisa_source)


@pytest.mark.parametrize("n,m", SIZES)
@pytest.mark.parametrize("variant", ["block", "avg"])
@pytest.mark.parametrize("loss,backend", [("hinge", "kernel"),
                                          ("hinge", "ref"),
                                          ("squared", "kernel")])
def test_radisa_matches_reference(n, m, variant, loss, backend):
    X, y = make_problem(n, m, seed=2)
    # eta * 2 ||x_j||^2 < 2 keeps the squared-loss SGD steps contractive
    gamma = 0.01 if loss == "squared" else 0.05
    kw = dict(lam=0.05, outer_iters=ITERS, variant=variant, gamma=gamma,
              seed=5)
    res_j, its_j = collect(
        j_get_solver("radisa")(engine="simulated", local_backend="ref"),
        loss, X, y, JRADiSA(**kw))
    res_t, its_t = collect(
        get_solver("radisa")(local_backend=backend, device="cpu",
                             index_source=radisa_source(5, n)),
        loss, X, y, RADiSAConfig(**kw))
    compare(res_t, its_t, res_j, its_j, dual=False)
    assert res_t.alpha is None


def test_simulated_wrappers_and_subblock_check():
    X, y = make_problem(101, 37, seed=10)
    data = partition(X, y, P, Q, device="cpu")          # m_q = 19, P = 3
    cfg = RADiSAConfig(lam=0.05, outer_iters=2, gamma=0.05, seed=5)
    from repro_torch.core.radisa import radisa_simulated_program
    from repro_torch.core.losses import get_loss
    with pytest.raises(ValueError, match="does not divide m_q"):
        radisa_simulated_program(get_loss("hinge"), data, cfg)
    seen = []
    w = radisa_simulated("hinge", data, cfg,
                         callback=lambda t, w: seen.append(t),
                         index_source=radisa_source(5, 101, iters=2))
    assert seen == [1, 2] and w.shape[0] >= 37
    res = get_solver("radisa")(device="cpu", index_source=radisa_source(
        5, 101, iters=2)).solve("hinge", X, y, P=P, Q=Q, cfg=cfg)
    np.testing.assert_allclose(w[:37].numpy(), res.w.numpy(), **TOL)
