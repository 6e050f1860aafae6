"""The roofline and the dry run (``repro_torch/roofline``,
``repro_torch/launch/dryrun.py``) against the reference's
``repro/roofline`` and ``repro/launch/dryrun.py``.

``model_flops`` equals the reference's for every arch and shape;
``roofline_terms`` equals the reference's on the same ``Hardware``; the
H100's numbers are the data sheet's.  The collectives counted from the
specs equal what the steps hand to their collectives when they run: a
2 x 2 CPU grid's Qwen3 training step (``wire_bytes``) and granite decode
step (``serve_wire_bytes``, its one KV head split by cache length) read
``coll.WIRE``.  ``run_cell`` on full-size cells of both production
meshes, ``run_calibration`` and ``run_paper_cell`` (D3CA and RADiSA, both
backends) write the reference's keys, each cell's counted bytes equal to
the specs'; the skips are the reference's."""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.models.config import LM_SHAPES as REF_SHAPES
from repro.roofline import model as ref_roofline
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import dryrun, mesh_train
from repro_torch.launch.mesh import close_grids, make_mesh, process_grid
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models import Transformer
from repro_torch.models.config import LM_SHAPES, ShapeConfig
from repro_torch.optim import AdamWConfig
from repro_torch.roofline import (HW_H100, Hardware, collective_bytes,
                                  model_flops, roofline_terms,
                                  step_collectives)
from repro_torch.sharding import collectives as coll
from test_torch_common import MESH_GRID_TIMEOUT, bounded, lm_pair  # noqa: F401

pytestmark = pytest.mark.usefixtures("bounded")

#: the keys of the reference's records (``repro/launch/dryrun.py``)
CELL_KEYS = {"arch", "shape", "mesh", "kind", "status", "flops",
             "bytes_accessed", "memory", "collectives"}
COLL_KEYS = {"total_bytes", "by_kind_bytes", "by_kind_count"}


@pytest.fixture(scope="module", autouse=True)
def _close_at_end():
    yield
    close_grids()


@pytest.fixture
def out(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_DRYRUN_DIR", str(tmp_path))
    return tmp_path


def _ref_dryrun():
    """The reference's dry-run module, imported without the 512 host
    devices it asks for at import (this process's jax keeps its own)."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return ref


def test_archs_and_shapes_are_the_references():
    assert ARCHS == REF_ARCHS
    assert [dataclasses.astuple(s) for s in LM_SHAPES] == \
        [dataclasses.astuple(s) for s in REF_SHAPES]


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_the_references(arch):
    for shape, rshape in zip(LM_SHAPES, REF_SHAPES):
        assert model_flops(get_config(arch), shape) == \
            ref_roofline.model_flops(ref_get_config(arch), rshape)


def test_roofline_terms_equal_the_references_on_the_same_hardware():
    hw = ref_roofline.HW_V5E
    mine = Hardware(hw.name, hw.peak_flops, hw.hbm_bw, hw.ici_bw,
                    hw.ici_links)
    for args in ((1e15, 1e9, 1e8), (1e12, 1e12, 1e6), (1e9, 1e6, 1e12)):
        assert roofline_terms(*args, mine) == \
            ref_roofline.roofline_terms(*args, hw)
    assert (HW_H100.peak_flops, HW_H100.hbm_bw) == (989e12, 3.35e12)
    assert HW_H100.ici_bw * HW_H100.ici_links == 450e9
    assert roofline_terms(989e12, 0, 0)["bound_s"] == 1.0


def test_cell_skips_are_the_references():
    ref = _ref_dryrun()
    skipped = 0
    for arch in ARCHS:
        for shape, rshape in zip(LM_SHAPES, REF_SHAPES):
            got = dryrun.cell_skip_reason(get_config(arch), shape)
            assert got == ref.cell_skip_reason(ref_get_config(arch), rshape)
            skipped += got is not None
    assert skipped == sum(not get_config(a).sub_quadratic for a in ARCHS)


def test_collective_bytes_take_the_references_wire_factors():
    got = collective_bytes({"all_gather": 10, "reduce_scatter": 0,
                            "all_reduce": 7}, {"all_gather": 2,
                                               "all_reduce": 1})
    assert got == {"total_bytes": 24.0,
                   "by_kind_bytes": {"all-gather": 10.0, "all-reduce": 14.0},
                   "by_kind_count": {"all-gather": 2, "all-reduce": 1}}


# ---------------------------------------------------------------------------
# the specs' count against the steps' own on a CPU grid
# ---------------------------------------------------------------------------

def _grid_model(arch, shape=(2, 2)):
    process_grid(shape[0], shape[1], device="cpu", timeout=MESH_GRID_TIMEOUT)
    _, rparams, pmodel, _ = lm_pair(arch)
    model = Transformer(pmodel.cfg, device="cpu",
                        mesh=make_mesh(shape, ("data", "model"),
                                       device="cpu"))
    return model, mesh_train.put_params(model,
                                        jax.tree.map(np.asarray, rparams))


def test_train_count_equals_wire_bytes_and_the_grids_wire():
    model, params = _grid_model("qwen3-1.7b")
    B, S, acc = 4, 32, 2
    shape = ShapeConfig("t", S, B, "train")
    spec = step_collectives(model, shape, acc)
    assert spec == collective_bytes(mesh_train.wire_bytes(model, B, S, acc))
    step = make_train_step(model, AdamWConfig(lr=1e-3), acc)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, model.cfg.vocab, (B, S)).astype(np.int32)
    before = dict(coll.WIRE)
    step(params, mesh_train.init_opt(model, params),
         {"tokens": toks, "labels": toks})
    assert collective_bytes(step.last["wire"])["by_kind_bytes"] == \
        spec["by_kind_bytes"]
    # rank 0 is this process: its own counters moved as much
    assert {k: coll.WIRE[k] - before[k] for k in coll.WIRE} == \
        step.last["wire"]


def test_decode_count_equals_the_grids_wire():
    """granite's one KV head over "model": the decode step's query gather
    and log-sum-exp merge are in the count."""
    model, params = _grid_model("granite-20b")
    B, S, L = 4, 12, 16
    rng = np.random.default_rng(1)
    toks = rng.integers(0, model.cfg.vocab, (B, S)).astype(np.int32)
    _, cache = make_prefill_step(model, L)(params, {"tokens": toks})
    decode = make_decode_step(model)
    decode(params, cache, {"tokens": toks[:, :1]})
    spec = step_collectives(model, ShapeConfig("d", L, B, "decode"))
    assert collective_bytes(decode.last["wire"])["by_kind_bytes"] == \
        spec["by_kind_bytes"]
    # beyond the vocab-parallel head's gather of a rank's B / 2 rows
    assert spec["by_kind_bytes"]["all-gather"] > B // 2 * model.cfg.vocab * 4
    assert spec["once"]["total_bytes"] > 0


# ---------------------------------------------------------------------------
# full-size cells on the production meshes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape,multi_pod", [
    ("qwen3-1.7b", "train_4k", False),
    ("granite-20b", "decode_32k", True),
    ("mixtral-8x7b", "prefill_32k", False),
    ("rwkv6-3b", "long_500k", True),
    ("recurrentgemma-9b", "decode_32k", False),
    ("llama-3.2-vision-90b", "decode_32k", True),
    ("musicgen-large", "long_500k", False),
])
def test_run_cell_writes_the_references_keys(out, arch, shape, multi_pod):
    got = dryrun.run_cell(arch, shape, multi_pod)
    mesh = "2x16x16" if multi_pod else "16x16"
    with open(out / f"{arch}__{shape}__{mesh}.json") as fh:
        assert json.load(fh) == json.loads(json.dumps(got))
    if got["status"] == "skipped":
        assert got["reason"] and arch == "musicgen-large"
        return
    assert CELL_KEYS <= set(got) and COLL_KEYS <= set(got["collectives"])
    assert got["flops"] > 0 and got["bytes_accessed"] > 0
    assert got["collectives"]["total_bytes"] > 0
    mem = got["memory"]
    assert mem["device_bytes"] == 80e9 and mem["total_bytes"] == sum(
        mem[k] for k in mem["counted"])
    assert "activations" in mem["not_counted"]
    if got["kind"] == "train":
        assert got["accum_steps"] == get_config(arch).train_accum
        assert {"opt_bytes", "view_grads_bytes"} <= set(mem)
    else:
        assert "once" in got["collectives"] and "cache_bytes" in mem
    assert got["roofline"]["dominant"] in ("compute", "memory",
                                           "collective")


def test_run_calibration_counts_one_and_two_periods(out):
    got = dryrun.run_calibration("recurrentgemma-9b", "decode_32k")
    a, b = got["variants"]["A"], got["variants"]["B"]
    assert (a["layers"], b["layers"]) == (3, 6)
    assert b["flops"] > a["flops"] > 0
    assert b["collectives"]["total_bytes"] > a["collectives"]["total_bytes"]
    assert os.path.exists(out / "recurrentgemma-9b__decode_32k__calib.json")
    assert dryrun.run_calibration("qwen3-1.7b", "long_500k") is None


@pytest.mark.parametrize("algo", ["d3ca", "radisa"])
def test_run_paper_cell_on_both_backends(out, algo):
    ref = dryrun.run_paper_cell(algo, block_n=4096, block_m=512)
    ker = dryrun.run_paper_cell(algo, block_n=4096, block_m=512,
                                local_backend="kernel")
    for got in (ref, ker):
        assert {"arch", "shape", "mesh", "kind", "status", "P", "Q",
                "inner_steps", "local_backend", "full", "calib_A",
                "calib_B"} <= set(got)
        assert (got["P"], got["Q"], got["inner_steps"]) == (16, 16, 4096)
        full = got["full"]
        assert COLL_KEYS <= set(full["collectives"])
        assert full["bytes_accessed"] > got["calib_B"]["bytes_accessed"] \
            > got["calib_A"]["bytes_accessed"]
        # the same declared collectives whatever the backend
        assert full["collectives"] == ref["full"]["collectives"]
        assert full["collectives"]["by_kind_count"]
    # FlopCounterMode counts matrix products: the plain loop's steps are
    # element-wise (none), the kernels' meta paths count theirs
    assert ker["full"]["flops"] > ker["calib_B"]["flops"] > \
        ker["calib_A"]["flops"]
    a, b = ref["calib_A"], ref["calib_B"]
    for key in ("flops", "bytes_accessed"):
        assert ref["full"][key] == a[key] + 4095 * (b[key] - a[key])
    assert os.path.exists(out / f"paper_svm_{algo}__16x16.json")
    assert os.path.exists(out / f"paper_svm_{algo}__16x16__kernel.json")


def test_cli_writes_a_cell(out, capsys):
    assert dryrun.main(["--arch", "qwen3-1.7b", "--shape",
                        "decode_32k"]) == 0
    assert os.path.exists(out / "qwen3-1.7b__decode_32k__16x16.json")
    assert "OK" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        dryrun.main([])
