"""The port's data pipeline, checkpoints and trainer against the reference:

* ``SyntheticLM.batch_at`` equal to the reference's for several steps,
  hosts and frontends, and ``TokenFileSource`` on one file;
* checkpoints: the round trip, no partial checkpoint after a crash, the
  crc32 catching corruption, a bf16 leaf as its 2-byte words;
* a smoke float32 ``TrainState`` (int8 moments too) saved by either package
  restores in the other, leaf for leaf, and the two manifests' paths,
  shapes, dtypes and crcs are equal;
* resume exact: 6 steps with ``ckpt_every=3``, then resumed to 9, equal bit
  for bit to an uninterrupted 9-step run.  The reference's own trainer
  cannot be the oracle here: its host mesh fails under jax 0.9
  (``test_substrate.py::test_trainer_resume_exact``, ROADMAP §3).
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.data import pipeline as JP
from repro.optim import adamw as JA
from repro.train import checkpoint as jck
from repro.train import steps as JSt
from repro_torch.configs import smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import pipeline as P
from repro_torch.models import transformer as T
from repro_torch.optim import adamw as A
from repro_torch.train import checkpoint as ck
from repro_torch.train import steps as St
from repro_torch.train.trainer import TrainerConfig, train


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("arch", ["yi-6b", "qwen2-vl-2b", "musicgen-medium"])
def test_synthetic_batches_equal_reference(arch):
    jcfg, cfg = j_smoke(arch), smoke_config(arch)
    want = JP.make_source(jcfg, JShapeConfig("t", 24, 8, "train"), seed=3)
    got = P.make_source(cfg, ShapeConfig("t", 24, 8, "train"), seed=3)
    for step in (0, 1, 17):
        for host, n in ((0, 1), (1, 2), (3, 4)):
            a = want.batch_at(step, host_id=host, n_hosts=n)
            b = got.batch_at(step, host_id=host, n_hosts=n)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
    assert next(got.stream(5))["tokens"].tolist() == got.batch_at(5)["tokens"].tolist()


def test_token_file_batches_equal_reference(tmp_path):
    path = tmp_path / "toks.bin"
    np.random.default_rng(0).integers(0, 60000, 5000).astype(np.uint16).tofile(path)
    want = JP.make_source(j_smoke("yi-6b"), JShapeConfig("t", 32, 4, "train"), path=str(path))
    got = P.make_source(smoke_config("yi-6b"), ShapeConfig("t", 32, 4, "train"), path=str(path))
    for step in (0, 9):
        np.testing.assert_array_equal(want.batch_at(step)["tokens"], got.batch_at(step)["tokens"])


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones((5,), dtype=torch.int8)}}
    ck.save(tmp_path, 7, tree, meta={"data_step": 7})
    assert ck.latest_step(tmp_path) == 7
    got, meta = ck.restore(tmp_path, 7, T.tree_map(torch.zeros_like, tree))
    assert meta["data_step"] == 7
    for a, b in zip(T.tree_leaves(tree), T.tree_leaves(got), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_crash_leaves_no_partial(tmp_path):
    ck.save(tmp_path, 1, {"a": torch.ones((4,))})
    (tmp_path / "step_000002.tmp-dead").mkdir()      # a writer that never renamed
    assert ck.latest_step(tmp_path) == 1
    ck.gc_old(tmp_path, keep=3)
    assert not list(tmp_path.glob("*.tmp-*"))
    for s in (2, 3, 4):
        ck.save(tmp_path, s, {"a": torch.ones((4,))})
    ck.gc_old(tmp_path, keep=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_000003", "step_000004"]


def test_checkpoint_crc_detects_corruption(tmp_path):
    d = ck.save(tmp_path, 3, {"a": torch.arange(100.0)})
    f = d / "shard_00000.npz"
    raw = bytearray(f.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    f.write_bytes(bytes(raw))
    with pytest.raises(Exception):
        ck.restore(tmp_path, 3, {"a": torch.zeros(100)})


def test_bf16_leaf_roundtrips_as_its_words(tmp_path):
    w = torch.randn((3, 5), generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    d = ck.save(tmp_path, 1, {"w": w})
    leaf = json.loads((d / "manifest.json").read_text())["leaves"][0]
    assert leaf["dtype"] == "bfloat16" and leaf["shape"] == [3, 5]
    with np.load(d / "shard_00000.npz") as data:
        words = data[leaf["key"]]
    assert words.dtype == np.uint16
    np.testing.assert_array_equal(words, w.view(torch.int16).numpy().view(np.uint16))
    got, _ = ck.restore(tmp_path, 1, {"w": torch.zeros((3, 5), dtype=torch.bfloat16)})
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], w)


def _manifest(d):
    return json.loads((d / "manifest.json").read_text())


@pytest.mark.parametrize("quantize_moments", [False, True], ids=["f32", "int8"])
def test_train_state_restores_across_packages(tmp_path, quantize_moments):
    jcfg, cfg = (j_smoke("yi-6b", n_layers=2, d_model=64, vocab_size=128),
                 smoke_config("yi-6b", n_layers=2, d_model=64, vocab_size=128))
    jopt = JA.AdamWConfig(quantize_moments=quantize_moments)
    opt = A.AdamWConfig(quantize_moments=quantize_moments)
    jstate = jax.jit(lambda k: JSt.init_train_state(jcfg, k, jopt))(jax.random.PRNGKey(0))
    jd = jck.save(tmp_path / "jax", 4, jstate, meta={"data_step": 4})
    # the port's target: its own random state, every leaf to be replaced
    target = St.init_train_state(cfg, torch.Generator().manual_seed(1), opt)
    state, meta = ck.restore(tmp_path / "jax", 4, target)
    assert meta == {"data_step": 4} and isinstance(state, St.TrainState)
    want = jck._paths(jstate)
    got = ck._paths(state)
    assert [p for p, _ in want] == [p for p, _ in got]
    for (path, a), (_, b) in zip(want, got, strict=True):
        assert str(np.asarray(a).dtype) == str(b.dtype)[6:], path
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=path)
    td = ck.save(tmp_path / "torch", 4, state, meta={"data_step": 4})
    jm, tm = _manifest(jd), _manifest(td)
    assert jm["leaves"] == tm["leaves"] and jm["meta"] == tm["meta"]
    shape_tree = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), jstate)
    back, _ = jck.restore(tmp_path / "torch", 4, shape_tree)
    for a, b in zip(jax.tree.leaves(jstate), jax.tree.leaves(back), strict=True):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_trainer_resume_is_exact(tmp_path):
    cfg = smoke_config("yi-6b", n_layers=2, d_model=64, vocab_size=128)
    shape = ShapeConfig("t", 32, 4, "train")
    opt = A.AdamWConfig(lr=1e-3)
    _, hist_a = train(cfg, shape, opt, TrainerConfig(steps=6, ckpt_every=3, ckpt_dir=str(
        tmp_path / "a"), log_every=100), device="cpu")
    assert len(hist_a) == 6 and ck.latest_step(tmp_path / "a") == 6
    # "crash" after step 6, resume to 9
    state_b, hist_b = train(cfg, shape, opt, TrainerConfig(steps=9, ckpt_every=3, ckpt_dir=str(
        tmp_path / "a"), log_every=100), device="cpu")
    assert int(state_b.step) == 9
    assert len(hist_b) == 3     # only steps 6..8 re-run (exactly-once data)
    state_c, hist_c = train(cfg, shape, opt, TrainerConfig(steps=9, log_every=100), device="cpu")
    assert [h["loss"] for h in hist_c[6:]] == [h["loss"] for h in hist_b]
    for (path, a), (_, b) in zip(ck._paths(state_b), ck._paths(state_c), strict=True):
        assert torch.equal(a, b), path


def test_trainer_watchdog_raises(tmp_path):
    cfg = smoke_config("yi-6b", n_layers=2, d_model=64, vocab_size=128)
    with pytest.raises(TimeoutError, match="watchdog"):
        train(cfg, ShapeConfig("t", 16, 2, "train"), A.AdamWConfig(),
              TrainerConfig(steps=2, watchdog_s=1e-9), device="cpu")
