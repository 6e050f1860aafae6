"""The port's checkpoint manager (CPU): the reference's test cases --
roundtrip, keep-N, async, no partial directories, shape mismatch,
concurrent readers, crash mid-swap -- and the on-disk layout shared with
``repro.checkpoint``: a tree either package saves, the other restores, and
a snapshot directory either package's ``SnapshotBook`` wrote, the other's
recovers."""
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.checkpoint import restore_tree as j_restore_tree
from repro.checkpoint import save_tree as j_save_tree
from repro.online import SnapshotBook as JBook
from repro_torch.checkpoint import CheckpointManager, restore_tree, save_tree
from repro_torch.online import SnapshotBook


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": torch.from_numpy(rng.normal(size=(8, 6)).astype(np.float32)),
            "nested": {"b": torch.arange(12.0).reshape(3, 4),
                       "i": torch.arange(5, dtype=torch.int64)},
            "lst": [torch.ones(2), torch.zeros(3)]}


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zeros_like(v) for v in tree)
    return None if tree is None else torch.zeros_like(tree)


def _assert_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_equal(x, y)
    elif a is None:
        assert b is None
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_roundtrip_keeps_structure_dtypes_and_device(tmp_path):
    t = _tree()
    t["tup"] = (torch.full((2,), 3.0), None)
    save_tree(str(tmp_path / "ck"), t)
    r = restore_tree(str(tmp_path / "ck"), _zeros_like(t), device="cpu")
    _assert_equal(t, r)
    assert r["nested"]["i"].dtype == torch.int64
    assert isinstance(r["tup"], tuple) and r["tup"][1] is None
    assert all(x.device.type == "cpu" for x in (r["a"], r["lst"][0]))


def test_manager_keep_n_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": torch.full((2,), float(s))})
    assert mgr.latest_step() == 4
    assert mgr.all_steps() == [3, 4]
    step, t = mgr.restore({"x": torch.zeros(2)}, device="cpu")
    assert step == 4 and float(t["x"][0]) == 4.0
    step, t = mgr.restore({"x": torch.zeros(2)}, step=3, device="cpu")
    assert step == 3 and float(t["x"][0]) == 3.0


def test_async_save_copies_before_the_caller_writes_on(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=3)
    t = _tree(1)
    want = _tree(1)
    mgr.save_async(7, t)
    t["a"].fill_(-5.0)              # the caller's buffer changes at once
    mgr.wait()
    step, r = mgr.restore(_zeros_like(t), device="cpu")
    assert step == 7
    _assert_equal(want, r)


def test_async_save_surfaces_its_error_on_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    (tmp_path / "step_00000003").write_text("a file where a dir goes")
    mgr.save_async(3, {"x": torch.zeros(2)})
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()                      # reported once


def test_atomic_no_partial_dirs(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=5)
    mgr.save(1, _tree())
    for d in os.listdir(tmp_path):
        assert not d.endswith(".tmp")


def test_restore_rejects_shape_mismatch_and_refuses_shardings(tmp_path):
    """A shape mismatch raises; ``shardings=`` re-shards (it once raised
    naming ROADMAP item 13c): a leaf whose sharding names a one-device
    mesh lands on that mesh's device, a None sharding on ``device`` --
    the multi-device re-shard is ``test_torch_mesh_train.py``'s."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding.layout import NamedSharding
    from repro_torch.sharding.rules import PartitionSpec
    save_tree(str(tmp_path / "ck"), {"x": torch.arange(3.0),
                                     "y": torch.ones(2)})
    with pytest.raises(ValueError):
        restore_tree(str(tmp_path / "ck"), {"x": torch.zeros(4),
                                            "y": torch.zeros(2)},
                     device="cpu")
    one = NamedSharding(make_mesh((1, 1), ("data", "model"), device="cpu"),
                        PartitionSpec(None))
    got = restore_tree(str(tmp_path / "ck"), {"x": torch.zeros(3),
                                              "y": torch.zeros(2)},
                       shardings={"x": one, "y": None}, device="cpu")
    torch.testing.assert_close(got["x"], torch.arange(3.0), rtol=0, atol=0)
    torch.testing.assert_close(got["y"], torch.ones(2), rtol=0, atol=0)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(
            {"x": torch.zeros(3)}, device="cpu")


def test_restore_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the rule under test is "
                    "what happens without one")
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.zeros(3)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mgr.restore({"x": torch.zeros(3)})


def test_concurrent_readers_see_complete_snapshots(tmp_path):
    """Readers restoring the latest step while a writer publishes new
    ones always get every leaf from the SAME version."""
    mgr = CheckpointManager(str(tmp_path), keep_n=0)   # no gc: isolate swap
    mgr.save(1, {"x": torch.full((4,), 1.0), "y": torch.full((3,), 1.0)})
    like = {"x": torch.zeros(4), "y": torch.zeros(3)}
    stop = threading.Event()
    torn = []

    def reader():
        while not stop.is_set():
            step, t = mgr.restore(like, device="cpu")
            x, y = float(t["x"][0]), float(t["y"][0])
            if not (x == y == float(step)):
                torn.append((step, x, y))

    threads = [threading.Thread(target=reader) for _ in range(3)]
    for th in threads:
        th.start()
    try:
        for s in range(2, 30):
            mgr.save(s, {"x": torch.full((4,), float(s)),
                         "y": torch.full((3,), float(s))})
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=30)
    assert not any(th.is_alive() for th in threads)
    assert torn == [], f"torn snapshot reads: {torn[:5]}"
    assert mgr.latest_step() == 29


def test_crash_mid_swap_recovers_previous_version(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=3)
    mgr.save(1, {"x": torch.full((2,), 1.0)})
    debris = tmp_path / "step_00000002.tmp"
    debris.mkdir()
    (debris / "leaf_00000.npy").write_bytes(b"partial")
    assert mgr.all_steps() == [1] and mgr.latest_step() == 1
    step, t = mgr.restore({"x": torch.zeros(2)}, device="cpu")
    assert step == 1 and float(t["x"][0]) == 1.0
    mgr.save(2, {"x": torch.full((2,), 2.0)})
    assert mgr.latest_step() == 2
    step, t = mgr.restore({"x": torch.zeros(2)}, device="cpu")
    assert step == 2 and float(t["x"][0]) == 2.0
    assert not os.path.exists(debris)


# ---------------------------------------------------------------------------
# one layout for both packages
# ---------------------------------------------------------------------------

def test_a_tree_the_port_saves_is_restored_by_the_reference(tmp_path):
    t = _tree(2)
    save_tree(str(tmp_path / "ck"), t)
    like = {"a": jnp.zeros((8, 6)),
            "nested": {"b": jnp.zeros((3, 4)), "i": jnp.zeros(5, jnp.int32)},
            "lst": [jnp.zeros(2), jnp.zeros(3)]}
    _assert_equal(t, j_restore_tree(str(tmp_path / "ck"), like))


def test_a_tree_the_reference_saves_is_restored_by_the_port(tmp_path):
    t = {"a": jnp.arange(48.0).reshape(8, 6),
         "nested": {"b": jnp.ones((3, 4))},
         "lst": [jnp.full((2,), 7.0), jnp.zeros((3,))]}
    j_save_tree(str(tmp_path / "ck"), t)
    like = {"a": torch.zeros(8, 6), "nested": {"b": torch.zeros(3, 4)},
            "lst": [torch.zeros(2), torch.zeros(3)]}
    r = restore_tree(str(tmp_path / "ck"), like, device="cpu")
    _assert_equal(t, r)
    assert r["a"].dtype == torch.float32


def test_snapshots_recover_across_the_packages(tmp_path):
    """A snapshot directory written by either package's SnapshotBook is
    recovered by the other's: version, trained_seq, w and alpha."""
    w, a = np.arange(4.0, dtype=np.float32), np.full(6, 0.5, np.float32)
    JBook(np.zeros(4), np.zeros(6), async_persist=False,
          manager=JManager(str(tmp_path / "ref"))).publish(w, a, 11)
    got = SnapshotBook(np.zeros(4), np.zeros(6), device="cpu",
                       manager=CheckpointManager(str(tmp_path / "ref"))
                       ).recover(np.zeros(4), np.zeros(6))
    assert (got.version, got.trained_seq) == (1, 11)
    np.testing.assert_array_equal(got.w.numpy(), w)
    np.testing.assert_array_equal(got.alpha.numpy(), a)

    book = SnapshotBook(np.zeros(4), np.zeros(6), device="cpu",
                        manager=CheckpointManager(str(tmp_path / "port")))
    book.publish(torch.from_numpy(w), torch.from_numpy(a), 5)
    book.publish(torch.from_numpy(w + 1), torch.from_numpy(a), 9)
    book.flush()
    back = JBook(np.zeros(4), np.zeros(6),
                 manager=JManager(str(tmp_path / "port"))).recover(
        np.zeros(4), np.zeros(6))
    assert (back.version, back.trained_seq) == (2, 9)
    np.testing.assert_array_equal(np.asarray(back.w), w + 1)
    np.testing.assert_array_equal(np.asarray(back.alpha), a)
