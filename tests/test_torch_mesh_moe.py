"""The MoE families' training over a (data, model) process grid against
the reference's single device, and a step over a ("pod", "data",
"model") mesh (the machinery and the tolerances of
``test_torch_mesh_families.py``).

On a 2 x 2 grid of CPU ranks (gloo), float32 compute: reduced Mixtral and
Moonshot (E = 4 over M = 2: each rank runs its 2 experts' slots) and a
reduced MoE with 3 experts (E % M != 0: the rules' ``expert_ff``
fallback, every expert on the rank's d_ff / 2 columns) train three steps
with one and four microbatches against the reference's jitted
single-device step (loss and grad norm every step, every parameter,
``mu`` and ``nu`` after the third, at 1e-5); every rank routes every
token of its rows from the full router (the experts chosen equal across
each "model" group) and its router gradient, a partial sum, is summed
over "model".  Then: reduced Qwen3 and Mixtral on a 2 x 1 x 2 ("pod",
"data", "model") mesh against the reference, and a Mixtral checkpoint
moving bitwise between 2 x 2, 4 x 1, one device and the reference."""
import pytest

from repro_torch.launch import mesh_train
from repro_torch.launch.mesh import close_grids
from test_torch_common import bounded  # noqa: F401
from test_torch_mesh_families import (_trained, check_checkpoint_to_one_device,
                                      check_reference_onto_grid,
                                      check_reshard_onto_4x1, check_split,
                                      check_steps)

pytestmark = pytest.mark.usefixtures("bounded")

CASES = [(f, acc) for f in ("mixtral", "moe3", "moonshot") for acc in (1, 4)]
POD = ((2, 1, 2), ("pod", "data", "model"))


@pytest.fixture(scope="module", autouse=True)
def _close_at_end():
    yield
    close_grids()


@pytest.mark.parametrize("fam,acc", CASES)
def test_moe_steps_match_reference(fam, acc):
    check_steps(fam, acc)


@pytest.mark.parametrize("fam,acc", CASES)
def test_moe_split_routes_and_wire_bytes(fam, acc):
    check_split(fam, acc)


@pytest.mark.parametrize("fam", ["qwen3", "mixtral"])
def test_pod_axis_step_matches_reference(fam):
    """The batch over the "pod" axis (2 x 1 x 2; the same 2 x 2 process
    grid): three steps of four microbatches against the reference's and
    the port's single device, the wire bytes of every step counted."""
    check_steps(fam, 4, *POD)
    model, *_, steps, _ = _trained(fam, 4, *POD)
    assert model.mesh.axis_names == POD[1]
    want = mesh_train.wire_bytes(model, 4, 32, 4)
    assert all(wire == want for *_, wire in steps)


def test_mixtral_checkpoint_saved_on_the_grid_restores_on_one_device(
        tmp_path):
    check_checkpoint_to_one_device("mixtral", tmp_path)


# ---------------------------------------------------------------------------
# another grid shape: 4 x 1 (these run last; the 2 x 2 grid closes)
# ---------------------------------------------------------------------------

def test_mixtral_checkpoint_reshards_bitwise_onto_4x1(tmp_path):
    check_reshard_onto_4x1("mixtral", tmp_path)


def test_reference_mixtral_checkpoint_restores_onto_the_grid(tmp_path):
    check_reference_onto_grid("mixtral", tmp_path)
