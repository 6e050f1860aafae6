"""The port's optimizers (``repro_torch.optim``) against the reference's
(``repro.optim``) on the CPU: AdamW's update on the same trees with and
without clipping, the learning-rate schedules, a RADiSA-SVRG step with the
reference's own Bernoulli mask injected, the cases of
``tests/test_optim.py`` on the port, the compression shim, and the AdamW
state carried across by ``convert.adamw_state_from_reference``.
Tolerances: 1e-6 (rtol = atol) after one update, 1e-5 after ten."""
import importlib
import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_init as ref_adamw_init
from repro.optim import adamw_update as ref_adamw_update
from repro.optim import radisa_svrg as ref_radisa
from repro.optim import schedules as ref_schedules
from repro_torch import convert
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               constant, global_norm, inverse_sqrt,
                               radisa_svrg, warmup_cosine)
from repro_torch.core.util import tree_leaves as leaves
from repro_torch.core.util import tree_map

TOL = 1e-6


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (scale * rng.normal(size=(5, 3))).astype(np.float32),
            "layers": [{"b": (scale * rng.normal(size=(4,))).astype(
                np.float32)},
                {"b": (scale * rng.normal(size=(4,))).astype(np.float32)}],
            "a": (scale * rng.normal(size=(2, 2, 2))).astype(np.float32)}


def _t(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(got, want, tol=TOL):
    gl, wl = leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("clip", [1.0, None, 1e3])
@pytest.mark.parametrize("lr", ["const", "sched"])
def test_adamw_update_matches_reference(clip, lr):
    """Ten updates on the same parameter / gradient trees; clip 1.0 clips
    every step (gradient norms ~ 5), 1e3 never does, None skips it."""
    p_np = _tree(0)
    rcfg = RefAdamWConfig(lr=0.05 if lr == "const" else
                          ref_schedules.warmup_cosine(0.05, 3, 10),
                          clip_norm=clip)
    cfg = AdamWConfig(lr=0.05 if lr == "const" else
                      warmup_cosine(0.05, 3, 10), clip_norm=clip)
    rp = jax.tree.map(jnp.asarray, p_np)
    ro = ref_adamw_init(rp)
    params = _t(p_np)
    opt = adamw_init(params)
    for s in range(10):
        g_np = _tree(100 + s, scale=2.0)
        rp, ro, rgn = ref_adamw_update(rcfg, jax.tree.map(jnp.asarray, g_np),
                                       ro, rp)
        grads = _t(g_np)
        ids = [id(x) for x in leaves(params)]
        params, opt, gn = adamw_update(cfg, grads, opt, params)
        assert [id(x) for x in leaves(params)] == ids     # in place
        np.testing.assert_allclose(float(gn), float(rgn), rtol=TOL)
        tol = TOL if s == 0 else 1e-5
        _close(params, rp, tol)
        _close(opt["mu"], ro["mu"], tol)
        _close(opt["nu"], ro["nu"], tol)
    assert int(opt["count"]) == int(ro["count"]) == 10
    assert opt["count"].dtype == torch.int32


def test_global_norm_matches_reference():
    t = _tree(3)
    from repro.optim import global_norm as ref_global_norm
    np.testing.assert_allclose(float(global_norm(_t(t))),
                               float(ref_global_norm(jax.tree.map(
                                   jnp.asarray, t))), rtol=TOL)


def test_adamw_bfloat16_params_cast_back():
    params = {"w": torch.ones(4, dtype=torch.bfloat16)}
    opt = adamw_init(params)
    assert opt["mu"]["w"].dtype == torch.bfloat16
    params, opt, _ = adamw_update(AdamWConfig(lr=0.1, weight_decay=0.0),
                                  {"w": torch.ones(4)}, opt, params)
    assert params["w"].dtype == torch.bfloat16
    assert float(params["w"][0]) < 1.0


@pytest.mark.parametrize("sched", ["warmup_cosine", "inverse_sqrt",
                                   "constant"])
def test_schedules_match_reference(sched):
    """Steps 0..N as Python ints and as 0-d int32 tensors."""
    make = {"warmup_cosine": (lambda m: m.warmup_cosine(3e-3, 5, 40)),
            "inverse_sqrt": (lambda m: m.inverse_sqrt(0.7)),
            "constant": (lambda m: m.constant(0.25))}[sched]
    mine = make(sys.modules["repro_torch.optim.schedules"])
    ref = make(ref_schedules)
    for s in range(45):
        want = float(ref(jnp.asarray(s, jnp.int32)))
        for step in (s, torch.tensor(s, dtype=torch.int32)):
            got = mine(step)
            # float32 arithmetic on both sides; torch's and XLA's cos
            # may round one ulp apart
            np.testing.assert_allclose(float(got), want, rtol=3e-7,
                                       atol=0)
            if sched != "constant":
                assert got.dtype == torch.float32
        np.testing.assert_allclose(float(mine(s)), float(ref(s)), rtol=3e-7)
    assert constant(0.25)(7) == 0.25
    assert float(inverse_sqrt(1.0)(1)) == 1.0


@pytest.mark.parametrize("frac", [0.5, 1.0, 0.0])
def test_radisa_svrg_step_matches_reference_with_its_mask(frac):
    """The reference's per-tensor jax.random.bernoulli mask, drawn with the
    same key and handed to the port as keep=."""
    p_np, g_np, ga_np, mu_np = (_tree(s) for s in (10, 11, 12, 13))
    cfg_r = ref_radisa.RadisaSVRGConfig(lr=0.1, block_fraction=frac)
    cfg = radisa_svrg.RadisaSVRGConfig(lr=0.1, block_fraction=frac)
    rp = jax.tree.map(jnp.asarray, p_np)
    rs = ref_radisa.refresh_anchor(ref_radisa.init(rp), rp,
                                   jax.tree.map(jnp.asarray, mu_np))
    params = _t(p_np)
    st = radisa_svrg.refresh_anchor(radisa_svrg.init(params), params,
                                    _t(mu_np))
    key = jax.random.PRNGKey(4)
    for i in range(3):
        key, sub = jax.random.split(key)
        n = len(jax.tree.leaves(rp))
        keep = np.asarray(jax.random.bernoulli(sub, frac, (n,)))
        rp, rs = ref_radisa.step(cfg_r, rp, rs,
                                 jax.tree.map(jnp.asarray, g_np),
                                 jax.tree.map(jnp.asarray, ga_np), sub)
        params, st = radisa_svrg.step(cfg, params, st, _t(g_np), _t(ga_np),
                                      keep=keep)
        _close(params, rp)
    assert int(st["count"]) == int(rs["count"]) == 3
    _close(st["anchor"], rs["anchor"])


def test_radisa_svrg_needs_a_mask_or_a_generator():
    params = {"w": torch.zeros(3)}
    st = radisa_svrg.init(params)
    g = {"w": torch.ones(3)}
    with pytest.raises(ValueError, match="Generator or keep"):
        radisa_svrg.step(radisa_svrg.RadisaSVRGConfig(), params, st, g, g)
    with pytest.raises(ValueError, match="1 tensors"):
        radisa_svrg.step(radisa_svrg.RadisaSVRGConfig(), params, st, g, g,
                         keep=[True, False])
    gen = torch.Generator().manual_seed(0)
    out, st2 = radisa_svrg.step(
        radisa_svrg.RadisaSVRGConfig(block_fraction=1.0), params, st, g,
        {"w": torch.zeros(3)}, gen)
    torch.testing.assert_close(out["w"], torch.full((3,), -1e-2))
    assert int(st2["count"]) == 1


# ---- the cases of tests/test_optim.py, on the port ----

def test_adamw_converges_quadratic():
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    opt = adamw_init(params)
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0)
    for _ in range(300):
        grads = {"w": params["w"] - target}
        params, opt, _ = adamw_update(cfg, grads, opt, params)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                               atol=1e-2)


def test_adamw_clipping():
    params = {"w": torch.zeros(4)}
    opt = adamw_init(params)
    cfg = AdamWConfig(lr=0.1, clip_norm=1.0, weight_decay=0.0)
    _, _, gn = adamw_update(cfg, {"w": torch.full((4,), 100.0)}, opt,
                            params)
    assert float(gn) == 200.0   # reported norm is pre-clip


def test_radisa_svrg_on_least_squares():
    rng = np.random.default_rng(0)
    A = torch.from_numpy(rng.normal(size=(64, 8)).astype(np.float32))
    xstar = torch.from_numpy(rng.normal(size=(8,)).astype(np.float32))
    b = A @ xstar

    def grad_at(w, rows):
        r = A[rows] @ w["w"] - b[rows]
        return {"w": A[rows].T @ r / len(rows)}

    params = {"w": torch.zeros(8)}
    cfg = radisa_svrg.RadisaSVRGConfig(lr=0.3, block_fraction=1.0)
    state = radisa_svrg.init(params)
    gen = torch.Generator().manual_seed(0)
    for outer in range(8):
        state = radisa_svrg.refresh_anchor(
            state, params, grad_at(params, torch.arange(64)))
        for inner in range(10):
            rows = torch.randint(0, 64, (8,), generator=gen)
            g_now = grad_at(params, rows)
            g_anc = grad_at(state["anchor"], rows)
            params, state = radisa_svrg.step(cfg, params, state, g_now,
                                             g_anc, gen)
    err = float(torch.linalg.norm(params["w"] - xstar))
    assert err < 0.05, err


def test_compression_shim_reexports_and_warns():
    import repro_torch.optim.compression  # noqa: F401  (may be cached)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        shim = importlib.reload(sys.modules["repro_torch.optim.compression"])
    assert any(issubclass(w.category, DeprecationWarning) for w in rec)
    from repro_torch.core import compress as new
    assert shim.init_error is new.init_error
    assert shim.compress is new.compress
    assert shim.decompress is new.decompress
    import repro_torch.optim as optim
    assert optim.compression is shim
    with pytest.raises(AttributeError):
        optim.no_such_thing


def test_import_optim_and_serve_are_silent():
    """A fresh interpreter: importing the packages warns nothing; touching
    the legacy names does."""
    code = ("import warnings; warnings.simplefilter('error');"
            "import repro_torch.optim, repro_torch.serve;"
            "warnings.simplefilter('always');"
            "import warnings as w\n"
            "with w.catch_warnings(record=True) as rec:\n"
            "    w.simplefilter('always')\n"
            "    repro_torch.serve.ServeMetrics; repro_torch.optim.compression\n"
            "assert sum(issubclass(r.category, DeprecationWarning)"
            " for r in rec) == 2, rec\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={**os.environ, "PYTHONPATH": "src"},
                   cwd=__file__.rsplit("/tests/", 1)[0])


def test_serve_metrics_shim_is_request_metrics():
    from repro_torch.obs.serve import RequestMetrics
    from repro_torch.serve import ServeMetrics
    assert issubclass(ServeMetrics, RequestMetrics)
    m = ServeMetrics()
    m.start_request(0, 4)
    assert "requests_finished" in m.summary()


def test_adamw_state_from_reference_continues():
    """A reference AdamW state after three updates, carried across, gives
    the port the reference's fourth update."""
    p_np = _tree(20)
    rcfg = RefAdamWConfig(lr=0.05)
    rp = jax.tree.map(jnp.asarray, p_np)
    ro = ref_adamw_init(rp)
    for s in range(3):
        rp, ro, _ = ref_adamw_update(rcfg, jax.tree.map(
            jnp.asarray, _tree(30 + s)), ro, rp)
    params = convert.lm_params_from_reference(jax.tree.map(np.asarray, rp),
                                              device="cpu")
    opt = convert.adamw_state_from_reference(jax.tree.map(np.asarray, ro),
                                             device="cpu")
    assert int(opt["count"]) == 3 and opt["count"].dtype == torch.int32
    g_np = _tree(40)
    rp, ro, _ = ref_adamw_update(rcfg, jax.tree.map(jnp.asarray, g_np), ro,
                                 rp)
    params, opt, _ = adamw_update(AdamWConfig(lr=0.05), _t(g_np), opt,
                                  params)
    _close(params, rp)
    _close(opt["nu"], ro["nu"])
