"""Every LM family's training over a (data, model) process grid against
the reference's single device (the recurrent, cross-attention and
embedding families here, the MoE families and the "pod" axis in
``test_torch_mesh_moe.py``, which shares this file's machinery).

On a 2 x 2 grid of CPU ranks (gloo), float32 compute, each family's
reduced config (built the same way in both packages) trains three steps
of ``make_train_step`` on a mesh, with one and with four microbatches,
against the reference's single-device jitted ``make_train_step``
(compiled once a family and accumulation, at XLA's backend optimization
level 0: half the compile time; for RWKV-6, whose parameters read
farthest, the reference's parameters after three steps lie within 0.87
of TOL of those at the default level) from the same weights: loss and
grad norm every step, every parameter, ``mu`` and ``nu`` after the
third, at 1e-5. The families: Mixtral (E = 4 over M = 2:
expert-parallel), a MoE with 3 experts (the rules' ``expert_ff``
fallback: every expert on the rank's d_ff columns), Moonshot, RWKV-6 (2
of 4 heads a rank), Llama-3.2-Vision at one period of 5 layers (its
XATTN on the encoder states of the rank's rows), RecurrentGemma at 5
layers (a remainder; LOCAL with its one KV head gathered whole) and
MusicGen (the embedding frontend). Then: every rank's blocks shaped as
the specs say, each rank's attention and scans on H / M heads (d_model /
M RG-LRU channels), the experts chosen equal across every "model" group,
the wire bytes of each step equal to ``mesh_train.wire_bytes``; a step
with a "pod" axis (2 x 1 x 2) against the reference; MoE and RWKV-6
checkpoints that move bitwise between 2 x 2, 4 x 1, one device and the
reference.

AdamW's eps is 1e-6, as in ``test_torch_mesh_train.py``.  Every
parameter is also held at 1e-5 against the port's own single-device step
from the same weights.  RWKV-6's parameters are held against the
reference at ``test_torch_train.py``'s trajectory tolerance (1e-4): the
port's single-device step, with no grid, sits 3.0e-5 from the reference
(2.9 TOL; 2.4 against the reference at level 0) at one entry of the first
channel mix's ``w_out``, [118, 63], from the first step on.  That entry's
first gradient is 5.5e-8 in the port and 7.8e-8 in the reference after
AdamW's clipping (the leaf's median |g| is 1.6e-3); below AdamW's eps the
first update lr g / (|g| + eps) is linear in g, so the 2.3e-8 between
them, over eps = 1e-6, times the first rate 1.5e-3, is the 3e-5.

It is the conditioning of that entry, not a sum that rounds wrongly.
Before clipping (one microbatch) the entry is the sum over the step's 128
tokens of h[t, 118] dout[t, 63] (h the squared-ReLU activation, dout the
gradient of the channel mix's output).  Summed in float64 from each
package's own float32 operands: port 1.0518e-7, reference 1.4824e-7.
Each package's float32 result sits next to its own float64 sum: port
1.0477e-7 (4.1e-10 off), reference 1.4833e-7 (9.1e-11 off), where the
float32 bound gamma_128 sum|terms| is 1.53e-7 (sum|terms| = 0.02011).
The two float64 sums differ by 4.3e-8, 2.1e-6 of sum|terms|: the
operands themselves differ by float32 rounding upstream, and a sum that
cancels to 5e-6 of its terms' magnitude turns that into a 30 % change.
``test_rwkv6_w_out_gradient_within_the_float32_bound`` holds the port's
gradient of that leaf against the float64 sum of its operands, entry by
entry, within the float32 bound.  The grid holds the single-device step
at 1e-5 (ROADMAP C files the entry under "Choices")."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import save_tree as ref_save_tree
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_init as ref_adamw_init
from repro.optim import warmup_cosine as ref_warmup_cosine
from repro_torch.checkpoint import restore_tree, save_tree
from repro_torch.core.util import tree_leaves as leaves
from repro_torch.core.util import tree_map
from repro_torch.data import synthetic_lm_batch
from repro_torch.launch import mesh_train
from repro_torch.launch.mesh import close_grids, make_mesh, process_grid
from repro_torch.launch.steps import (make_train_step, opt_shardings,
                                      param_shardings)
from repro_torch.models import Transformer
from repro_torch.models.config import ATTN, LOCAL, RGLRU, RWKV, XATTN
from repro_torch.optim import AdamWConfig, adamw_init, warmup_cosine
from repro_torch.sharding import resident
from test_torch_common import MESH_GRID_TIMEOUT, bounded, lm_pair  # noqa: F401

pytestmark = pytest.mark.usefixtures("bounded")

TOL = 1e-5
EPS = 1e-6
B, S = 4, 32
#: family id: (arch, overrides of its reduced config)
FAMILIES = {
    "mixtral": ("mixtral-8x7b", {}),
    "moe3": ("mixtral-8x7b", {"n_experts": 3}),
    "moonshot": ("moonshot-v1-16b-a3b", {}),
    "rwkv6": ("rwkv6-3b", {}),
    "vision": ("llama-3.2-vision-90b", {"n_layers": 5}),
    "recurrentgemma": ("recurrentgemma-9b", {"n_layers": 5}),
    "musicgen": ("musicgen-large", {}),
}
#: ... and the dense-attention family, for the step with a "pod" axis
FAMILIES["qwen3"] = ("qwen3-1.7b", {})
CASES = [(f, acc) for f in ("rwkv6", "vision", "recurrentgemma", "musicgen")
         for acc in (1, 4)]
#: parameters against the reference where the single-device step itself
#: is farther than TOL from it (see the module docstring)
REF_PARAM_TOL = {"rwkv6": 1e-4}
GRID = (2, 2)
AXES = ("data", "model")


@pytest.fixture(scope="module", autouse=True)
def _close_at_end():
    yield
    close_grids()


def _mesh(shape, axes=AXES):
    """The mesh of ``shape`` on its memoized CPU grid (batch axes x
    "model"), started with the tests' bound."""
    model = shape[-1]
    process_grid(int(np.prod(shape[:-1])), model, device="cpu",
                 timeout=MESH_GRID_TIMEOUT)
    return make_mesh(shape, axes, device="cpu")


def _opt():
    return AdamWConfig(lr=warmup_cosine(3e-3, 2, 10), eps=EPS)


def _close(got, want, what, tol=TOL):
    for i, (g, w) in enumerate(zip(leaves(got), leaves(want))):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=tol,
                                   atol=tol, err_msg=f"{what} leaf {i}")


_REFS, _RUNS = {}, {}


def _batch(cfg, s):
    return synthetic_lm_batch(cfg, s, batch=B, seq=S)


def _reference(fam, acc):
    """The reference's jitted single-device step (compiled once, at XLA's
    backend optimization level 0: half the compile time; see the module
    docstring for its distance from the default level) and the port's
    one-device step, three steps each from the reference's weights: (each step's
    reference metrics, the reference's final (params, opt state), the
    port's final parameters); cached per family and accumulation."""
    key = (fam, acc)
    if key not in _REFS:
        arch, over = FAMILIES[fam]
        rmodel, rparams, pmodel, pparams = lm_pair(arch, **over)
        rp, ro = rparams, ref_adamw_init(rparams)
        batches = [{k: jnp.asarray(v) for k, v in _batch(pmodel.cfg, s)
                    .items()} for s in range(3)]
        r_step = jax.jit(ref_make_train_step(
            rmodel, RefAdamWConfig(lr=ref_warmup_cosine(3e-3, 2, 10),
                                   eps=EPS), acc)).lower(
            rp, ro, batches[0]).compile(
                {"xla_backend_optimization_level": 0})
        one = make_train_step(pmodel, _opt(), acc)
        p1 = tree_map(lambda t: t.detach().clone(), pparams)
        o1 = adamw_init(p1)
        metrics = []
        for s, b in enumerate(batches):
            rp, ro, rm = r_step(rp, ro, b)
            p1, o1, _ = one(p1, o1, _batch(pmodel.cfg, s))
            metrics.append(rm)
        _REFS[key] = (metrics, (rp, ro), p1)
    return _REFS[key]


def _trained(fam, acc, shape=GRID, axes=AXES):
    """Three steps of family ``fam`` on the mesh of ``shape`` from the
    reference's weights, beside :func:`_reference`'s: (model, param and
    optimizer handles, the reference's final state, the port's one-device
    parameters, each step's (metrics, reference metrics, wire bytes), the
    ranks' readings)."""
    key = (fam, acc, shape)
    if key in _RUNS:
        return _RUNS[key]
    arch, over = FAMILIES[fam]
    _, rparams, pmodel, _ = lm_pair(arch, **over)
    ref_metrics, (rp, ro), p1 = _reference(fam, acc)
    model = Transformer(pmodel.cfg, device="cpu", mesh=_mesh(shape, axes))
    params = mesh_train.put_params(model, jax.tree.map(np.asarray, rparams))
    opt = mesh_train.init_opt(model, params)
    step = make_train_step(model, _opt(), acc)
    steps, routes = [], None
    for s, rm in enumerate(ref_metrics):
        last = s == len(ref_metrics) - 1 and model.cfg.moe is not None
        with (mesh_train.expert_routes(model.mesh) if last
              else contextlib.nullcontext()) as seen:
            params, opt, m = step(params, opt, _batch(pmodel.cfg, s))
        routes = seen if last else routes
        steps.append((m, rm, dict(step.last["wire"])))
    readings = {"heads": mesh_train.attention_heads(model),
                "scan": mesh_train.scan_widths(model), "routes": routes}
    _RUNS[key] = (model, params, opt, (rp, ro), p1, steps, readings)
    return _RUNS[key]


def check_steps(fam, acc, shape=GRID, axes=AXES):
    """The grid's three steps against the reference's and the port's
    single device (see the module docstring)."""
    model, params, opt, (rp, ro), p1, steps, _ = _trained(fam, acc, shape,
                                                          axes)
    for m, rm, _ in steps:
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(rm[k]), rtol=TOL,
                                       atol=TOL, err_msg=k)
    full = resident.gather_tree(params)
    _close(full, p1, "param vs one device")
    _close(full, jax.tree.leaves(rp), "param vs reference",
           REF_PARAM_TOL.get(fam, TOL))
    fopt = resident.gather_tree(opt)
    for k in ("mu", "nu"):
        _close(fopt[k], jax.tree.leaves(ro[k]), f"{k} vs reference")
    assert int(fopt["count"]) == 3


def check_split(fam, acc):
    """Each rank's blocks are the specs' local shapes; "model" splits
    every layer kind's work (H / M query heads -- KV heads too, or the
    one KV head whole --, H / M RWKV heads, d_model / M RG-LRU channels,
    the experts or their d_ff); the ranks of a "model" group chose the
    same experts; every step's wire bytes are ``wire_bytes``'s count."""
    model, params, _, _, _, steps, seen = _trained(fam, acc)
    cfg, tp = model.cfg, model.tp
    want = [h.struct.local_shape for h in leaves(params)]
    for rank, shapes in resident.block_shapes(params).items():
        assert shapes == want, rank
    kinds = set(cfg.pattern)
    if kinds & {ATTN, LOCAL, XATTN}:
        kv = cfg.n_kv // 2 if cfg.n_kv % 2 == 0 else cfg.n_kv
        assert tp["heads_local"] and tp["kv_local"] == (cfg.n_kv % 2 == 0)
        # Vision's last layer is XATTN: its heads are recorded by the
        # self-attention layers before it
        assert seen["heads"] == [(cfg.n_heads // 2, kv)] * 4
    if RWKV in kinds:
        assert tp["rwkv_local"] and tp["cm_local"]
        assert seen["scan"] == [("rwkv", cfg.rwkv_heads // 2)] * 4
    elif RGLRU in kinds:
        assert tp["rglru_local"] and tp["ff_local"]
        # the remainder's last layer is an RG-LRU layer
        assert seen["scan"] == [("rglru", cfg.d_model // 2)] * 4
    if cfg.moe is not None:
        E = cfg.moe.n_experts
        assert tp["moe"] == ("experts" if E % 2 == 0 else "expert_ff")
        routes = seen["routes"]
        assert routes[0] and routes[0] == routes[1] and routes[2] == routes[3]
        assert routes[0] != routes[2]           # other rows, other choices
    assert tp["embed_vp"] == (cfg.embed_input == "tokens")
    predicted = mesh_train.wire_bytes(model, B, S, acc)
    for *_, wire in steps:
        assert wire == predicted
    assert predicted["all_gather"] > 0 and predicted["reduce_scatter"] > 0


def check_checkpoint_to_one_device(fam, tmp_path):
    """The grid's trained tree (four microbatches) saved from the grid
    and restored on one device, bitwise; kept for the 4 x 1 case."""
    model, params, opt = _trained(fam, 4)[:3]
    save_tree(str(tmp_path / "ck"), {"params": params, "opt": opt})
    full = {"params": resident.gather_tree(params),
            "opt": resident.gather_tree(opt)}
    one = Transformer(model.cfg, device="cpu")
    like = {"params": one.init(1), "opt": adamw_init(one.init(1))}
    got = restore_tree(str(tmp_path / "ck"), like, device="cpu")
    for g, w in zip(leaves(got), leaves(full)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    _CKPTS[fam] = (model.cfg, str(tmp_path / "ck"), full)


_CKPTS = {}


def _on_4x1(cfg, path):
    mesh = _mesh((4, 1))
    m41 = Transformer(cfg, device="cpu", mesh=mesh)
    structs, _, specs = param_shardings(m41, mesh)
    shard = {"params": structs, "opt": opt_shardings(structs, mesh, specs)}
    got = restore_tree(path, shard, shardings=shard, device="cpu")
    assert isinstance(leaves(got)[0], resident.ShardedLeaf)
    return m41, got


def check_reshard_onto_4x1(fam, tmp_path):
    """The 2 x 2 grid's checkpoint restored onto a 4 x 1 grid, bitwise
    (the 2 x 2 grid closes: these run last in a file)."""
    if fam not in _CKPTS:
        check_checkpoint_to_one_device(fam, tmp_path)
    cfg, path, full = _CKPTS[fam]
    _, got = _on_4x1(cfg, path)
    back = {"params": resident.gather_tree(got["params"]),
            "opt": resident.gather_tree(got["opt"])}
    for g, w in zip(leaves(back), leaves(full)):
        np.testing.assert_array_equal(g, w)
    assert resident.block_shapes(got["params"])[3] == [
        h.struct.local_shape for h in leaves(got["params"])]
    resident.free(got["params"])
    resident.free(got["opt"])


def check_reference_onto_grid(fam, tmp_path):
    """The reference's checkpoint of the family's tree onto 4 x 1,
    bitwise, and a step from there equal to the reference's first."""
    arch, over = FAMILIES[fam]
    _, rparams, pmodel, _ = lm_pair(arch, **over)
    ref_save_tree(str(tmp_path / "ref"), {"params": rparams,
                                          "opt": ref_adamw_init(rparams)})
    model, got = _on_4x1(pmodel.cfg, str(tmp_path / "ref"))
    for g, w in zip(leaves(resident.gather_tree(got["params"])),
                    jax.tree.leaves(rparams)):
        np.testing.assert_array_equal(g, np.asarray(w))
    _, _, m = make_train_step(model, _opt(), 4)(got["params"], got["opt"],
                                                _batch(pmodel.cfg, 0))
    rm = _reference(fam, 4)[0][0]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(rm[k]), rtol=TOL,
                                   atol=TOL)
    resident.free(got["params"])
    resident.free(got["opt"])


@pytest.mark.parametrize("fam,acc", CASES)
def test_family_steps_match_reference(fam, acc):
    check_steps(fam, acc)


@pytest.mark.parametrize("fam,acc", CASES)
def test_family_split_heads_and_wire_bytes(fam, acc):
    check_split(fam, acc)


def test_rwkv6_checkpoint_saved_on_the_grid_restores_on_one_device(
        tmp_path):
    check_checkpoint_to_one_device("rwkv6", tmp_path)


def test_rwkv6_w_out_gradient_within_the_float32_bound(monkeypatch):
    """The first channel mix's ``w_out`` gradient of the reduced RWKV-6's
    first step (one microbatch, the reference's weights) against the
    float64 sum of its own float32 operands, sum_t h[t, i] dout[t, j],
    entry by entry within the float32 bound gamma_n sum_t |h dout| (n the
    step's B * S tokens): the backward's sum is as exact as a float32 sum
    can be, entry [118, 63] included (see the module docstring)."""
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import transformer
    _, _, pmodel, pparams = lm_pair("rwkv6-3b")
    w0 = pparams["periods"][0]["mlp"]["w_out"][0]
    real = transformer.rwkv_channel_mix
    seen = []

    def tapped(params, x, cfg, *, x_last=None):
        out, x_cm = real(params, x, cfg, x_last=x_last)
        if out.requires_grad and torch.equal(params["w_out"].detach(), w0):
            x_prev = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], 1)
            mix = params["mix"].detach()
            xm = x.detach() * mix + x_prev.detach() * (1.0 - mix)
            h = torch.square(torch.relu(xm @ params["w_in"].detach()))
            out.register_hook(lambda g: seen.append((h, g.detach())))
        return out, x_cm
    monkeypatch.setattr(transformer, "rwkv_channel_mix", tapped)
    params = tree_map(lambda t: t.detach().clone(), pparams)
    _, grads = loss_and_grads(pmodel, params, _batch(pmodel.cfg, 0),
                              accum_steps=1)
    (h, dout), = seen
    h = h.reshape(-1, h.shape[-1]).double()
    dout = dout.reshape(-1, dout.shape[-1]).double()
    n = h.shape[0]
    u = 2.0 ** -24
    want = h.T @ dout
    bound = n * u / (1 - n * u) * (h.abs().T @ dout.abs())
    got = grads["periods"][0]["mlp"]["w_out"][0].double()
    assert n == B * S and got.shape == want.shape
    assert bool(((got - want).abs() <= bound).all())
    # the entry of ROADMAP C: cancelled to ~5e-6 of its terms' magnitude
    assert abs(float(want[118, 63])) < 1e-5 * float(
        (h[:, 118] * dout[:, 63]).abs().sum())


# ---------------------------------------------------------------------------
# another grid shape: 4 x 1 (these run last; the 2 x 2 grid closes)
# ---------------------------------------------------------------------------

def test_rwkv6_checkpoint_reshards_bitwise_onto_4x1(tmp_path):
    check_reshard_onto_4x1("rwkv6", tmp_path)


def test_reference_rwkv6_checkpoint_restores_onto_the_grid(tmp_path):
    check_reference_onto_grid("rwkv6", tmp_path)
