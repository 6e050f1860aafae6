"""Every LM family's prefill and decode over a 2 x 1 (data, model) grid and
a 2 x 1 x 2 ("pod", "data", "model") mesh against the reference's single
device (the machinery, the inputs and the tolerance of
``test_torch_mesh_serve.py``): on 2 x 1 the batch splits over "data" and
nothing over "model" (every rank holds whole KV heads and the whole
cache length of its rows); on the pod mesh the batch splits over ("pod",
"data") and the work over "model" as on 1 x 2 -- granite's and
RecurrentGemma's single KV head by cache length."""
import pytest

from repro_torch.launch.mesh import close_grids
from test_torch_common import bounded  # noqa: F401
from test_torch_mesh_serve import ARCHS, POD_AXES, check_serve

pytestmark = pytest.mark.usefixtures("bounded")


@pytest.fixture(scope="module", autouse=True)
def _close_at_end():
    yield
    close_grids()


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_on_2x1_matches_the_reference(arch):
    model = check_serve(arch, (2, 1))[0]
    assert model.tp["M"] == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_on_a_pod_mesh_matches_the_reference(arch):
    model = check_serve(arch, (2, 1, 2), POD_AXES)[0]
    cfg = model.cfg
    if cfg.n_kv == 1 and set(cfg.pattern) & {"attn", "local"}:
        assert not model.tp["kv_local"]


def test_mesh_serve_cli(capsys):
    """``python -m repro_torch.launch.mesh_serve``: greedy decoding over
    the 2 x 1 grid, one JSON line with the tokens and the wire bytes of a
    step (the specs' count); without ``--device cpu`` it raises on a
    machine without a card."""
    import json

    import torch

    from repro_torch.launch import mesh_serve
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Transformer
    from test_torch_mesh_serve import mesh_of
    mesh_of((2, 1))
    argv = ["--arch", "mixtral-8x7b", "--reduced", "--mesh", "2,1",
            "--batch", "2", "--prompt-len", "8", "--cache-len", "16",
            "--gen", "3"]
    assert mesh_serve.main(argv + ["--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(out["greedy_tokens"]) == 3 and out["mesh"] == [2, 1]
    from repro_torch.configs import get_config
    from repro_torch.models import reduced
    model = Transformer(reduced(get_config("mixtral-8x7b")), device="cpu",
                        mesh=make_mesh((2, 1), ("data", "model"),
                                       device="cpu"))
    assert out["wire_decode"] == mesh_serve.serve_wire_bytes(
        model, 2, 16, "decode")["step"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            mesh_serve.main(argv)
