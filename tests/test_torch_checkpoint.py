"""The port's checkpoint store vs the JAX package's.

``repro_torch.checkpoint`` keeps ``repro.checkpoint``'s guarantees — a tmp
directory, the manifest last and fsynced, one ``os.replace``; torn steps
skipped with a warning; retention; background failures re-raised as
``CheckpointError``; ``wait(timeout=)`` — and its on-disk layout: the same
leaf numbering (JAX's sorted-key flatten), the same ``.npy`` bytes (bf16 as
``<V2`` voids under the dtype string ``bfloat16``) and the same manifest.
Each test of ``tests/test_checkpoint.py`` is read here on torch state, and
each package restores what the other wrote, bit for bit.
"""

import json
import shutil
import threading
import warnings
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as j_ckpt
from repro_torch.checkpoint import checkpoint as ckpt


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn(8, 16, generator=g),
                   "b": torch.randn(16, generator=g).to(torch.bfloat16)},
        "opt": {"mu": torch.ones(8, 16)},
        "step": torch.tensor(5, dtype=torch.int32),
    }


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    return torch.zeros_like(tree)


def _leaves(tree):
    return ckpt._flatten(tree)


def _bits(t) -> np.ndarray:
    """The raw bytes of a tensor or array (bf16 as its 16-bit pattern)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().copy()
        return t.numpy().copy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _assert_same(a, b):
    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(_bits(x), _bits(y))


# ---------------------------------------------------------------------------
# tests/test_checkpoint.py, on torch state
# ---------------------------------------------------------------------------


def test_roundtrip_identity(tmp_path):
    s = _state()
    ckpt.save(tmp_path, 5, s, extras={"iterator": {"seed": 1, "step": 5, "batch_size": 2}})
    restored, extras = ckpt.restore(tmp_path, _zeros_like(s))
    _assert_same(s, restored)
    assert set(restored) == set(s) and set(restored["params"]) == {"w", "b"}
    assert extras["iterator"]["step"] == 5


def test_latest_and_retention(tmp_path):
    s = _state()
    for step in [1, 2, 3, 4, 5]:
        ckpt.save(tmp_path, step, s, keep=3)
    assert ckpt.latest_step(tmp_path) == 5
    kept = sorted(p.name for p in Path(tmp_path).iterdir())
    assert kept == ["step_00000003", "step_00000004", "step_00000005"]


def test_torn_write_ignored(tmp_path):
    s = _state()
    ckpt.save(tmp_path, 1, s)
    (Path(tmp_path) / ".tmp-step_00000002").mkdir()
    broken = Path(tmp_path) / "step_00000003"
    broken.mkdir()
    (broken / "leaf_0.npy").write_bytes(b"garbage")
    with pytest.warns(UserWarning, match="skipping torn checkpoint"):
        assert ckpt.latest_step(tmp_path) == 1
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        restored, _ = ckpt.restore(tmp_path, _zeros_like(s))
    assert torch.equal(restored["params"]["w"], s["params"]["w"])
    assert ckpt.validate_step_dir(broken) == "missing manifest.json"


def test_async_checkpointer(tmp_path):
    s = _state()
    w0 = s["params"]["w"].clone()
    ac = ckpt.AsyncCheckpointer(tmp_path)
    ac.save(7, s, extras={"step": 7, "iterator": {"seed": 0, "step": 7, "batch_size": 1}})
    s["params"]["w"].add_(1.0)  # the snapshot was taken at save()
    ac.wait()
    assert ckpt.latest_step(tmp_path) == 7
    restored, _ = ckpt.restore(tmp_path, _zeros_like(s))
    assert torch.equal(restored["params"]["w"], w0)


def test_async_failure_propagates_as_checkpoint_error(tmp_path):
    s = _state()
    target = tmp_path / "ck"
    ac = ckpt.AsyncCheckpointer(target)
    ac.save(1, s)
    assert ac.wait()
    shutil.rmtree(target)
    target.write_text("now a file, not a directory")
    ac.save(2, s)
    with pytest.raises(ckpt.CheckpointError, match="background checkpoint save failed"):
        ac.wait()
    target.unlink()
    ac.save(3, s)
    assert ac.wait()
    assert ckpt.latest_step(target) == 3


def test_async_wait_timeout_bounds_shutdown(tmp_path, monkeypatch):
    gate = threading.Event()
    orig_save = ckpt.save

    def slow_save(*args, **kwargs):
        gate.wait()
        return orig_save(*args, **kwargs)

    ac = ckpt.AsyncCheckpointer(tmp_path / "ck")
    try:
        monkeypatch.setattr(ckpt, "save", slow_save)
        ac.save(1, _state())
        assert ac.wait(timeout=0.05) is False
    finally:
        gate.set()
    assert ac.wait() is True
    assert ckpt.latest_step(tmp_path / "ck") == 1


def test_restore_falls_back_over_corrupted_leaf(tmp_path):
    s = _state()
    ckpt.save(tmp_path, 1, s)
    ckpt.save(tmp_path, 2, s)
    leaf = Path(tmp_path) / "step_00000002" / "leaf_0.npy"
    leaf.write_bytes(leaf.read_bytes()[:48])
    with pytest.warns(UserWarning, match="falling back to the previous step"):
        restored, _ = ckpt.restore(tmp_path, _zeros_like(s))
    _assert_same(s, restored)
    with pytest.raises((ckpt.CheckpointError, ValueError)):
        ckpt.restore(tmp_path, _zeros_like(s), step=2)


def test_restore_rejects_shape_mismatch(tmp_path):
    s = _state()
    ckpt.save(tmp_path, 1, s)
    bad = dict(s, params={"w": torch.zeros(4, 4), "b": s["params"]["b"]})
    with pytest.raises(AssertionError):
        ckpt.restore(tmp_path, bad)
    with pytest.raises(ckpt.CheckpointError, match="is torn"):
        ckpt.restore(tmp_path, s, step=9)


# ---------------------------------------------------------------------------
# The layout: each package restores what the other wrote
# ---------------------------------------------------------------------------


def _jax_state(seed=0):
    rng = np.random.RandomState(seed)
    return {
        "params": {"w": jnp.asarray(rng.randn(8, 16).astype(np.float32)),
                   "b": jnp.asarray(rng.randn(16).astype(np.float32)).astype(jnp.bfloat16)},
        "opt": {"mu": jnp.ones((8, 16)), "count": jnp.arange(3, dtype=jnp.int32)},
        "step": jnp.int32(5),
        "l": [jnp.full((2,), 2.5, jnp.float32), (jnp.zeros((1, 2), jnp.bfloat16),)],
    }


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(v) for v in tree)
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_packages_restore_each_others_checkpoints(tmp_path, writer):
    js = _jax_state()
    ts = _to_torch(js)
    extras = {"step": 5, "note": "x"}
    if writer == "jax":
        j_ckpt.save(tmp_path, 5, js, extras=extras)
    else:
        ckpt.save(tmp_path, 5, ts, extras=extras)
    got, got_extras = ckpt.restore(tmp_path, _zeros_like_tree(ts))
    _assert_same(ts, got)
    assert got["params"]["b"].dtype == torch.bfloat16 and got["step"].dtype == torch.int32
    jgot, jextras = j_ckpt.restore(tmp_path, _jax_zeros(js))
    for a, b in zip(_leaves(js), _leaves(jgot), strict=True):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert np.asarray(jgot["params"]["b"]).dtype == np.dtype(ml_dtypes.bfloat16)
    assert got_extras == jextras == extras


def _zeros_like_tree(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zeros_like_tree(v) for v in tree)
    return torch.zeros_like(tree)


def _jax_zeros(tree):
    if isinstance(tree, dict):
        return {k: _jax_zeros(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_jax_zeros(v) for v in tree)
    return jnp.zeros_like(tree)


def test_files_are_the_jax_packages_byte_for_byte(tmp_path):
    """The same leaves in the same order, the same .npy bytes, the same manifest."""
    js = _jax_state(seed=3)
    j_ckpt.save(tmp_path / "jax", 2, js, extras={"step": 2})
    ckpt.save(tmp_path / "port", 2, _to_torch(js), extras={"step": 2})
    jd, td = tmp_path / "jax" / "step_00000002", tmp_path / "port" / "step_00000002"
    names = sorted(p.name for p in jd.iterdir())
    assert names == sorted(p.name for p in td.iterdir())
    for name in names:
        if name == "manifest.json":
            assert json.loads((td / name).read_text()) == json.loads((jd / name).read_text())
        else:
            assert (td / name).read_bytes() == (jd / name).read_bytes(), name
    manifest = json.loads((td / "manifest.json").read_text())
    assert "bfloat16" in manifest["dtypes"] and manifest["n_leaves"] == 7


def test_numpy_leaves_and_the_restore_device(tmp_path):
    """numpy leaves (an ml_dtypes bf16 among them) save as JAX's do; a
    restore puts every leaf on ``device`` when given, else on the template
    tensor's device, in the template's dtype."""
    state = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
             "b": np.asarray([1.5, -2.0], dtype=ml_dtypes.bfloat16), "n": 3}
    ckpt.save(tmp_path, 1, state)
    j_ckpt.save(tmp_path / "j", 1, state)
    for i in range(3):
        name = f"leaf_{i}.npy"
        assert ((tmp_path / "step_00000001" / name).read_bytes()
                == (tmp_path / "j" / "step_00000001" / name).read_bytes())
    got, _ = ckpt.restore(tmp_path, state, device="cpu")
    assert got["b"].dtype == torch.bfloat16 and got["b"].tolist() == [1.5, -2.0]
    assert got["n"].dtype == torch.int64 and int(got["n"]) == 3
    template = {"a": torch.zeros(2, 3, dtype=torch.float64), "b": torch.zeros(2),
                "n": torch.zeros((), dtype=torch.int32)}
    got, _ = ckpt.restore(tmp_path, template)
    assert got["a"].dtype == torch.float64 and got["b"].dtype == torch.float32
    assert torch.equal(got["a"], torch.arange(6, dtype=torch.float64).reshape(2, 3))
    assert all(v.device.type == "cpu" for v in got.values())


def test_treedef_string_is_jaxs():
    import jax

    js = _jax_state()
    js["none"] = None
    js["empty"] = {}
    assert ckpt._treedef(_to_torch_keep_none(js)) == str(jax.tree_util.tree_structure(js))


def _to_torch_keep_none(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _to_torch_keep_none(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch_keep_none(v) for v in tree)
    return _to_torch(tree)
