"""The port's data pipeline and checkpoints against the reference's
(``repro.data``, ``repro.checkpoint``): the same batches bit for bit, and
checkpoints of a nested dict that either package writes and the other
restores, with and without zstd (the manifest says which)."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as JCK
from repro.data import SyntheticLMDataset as JDataset
from repro.data import make_batch_iter as j_batch_iter
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.checkpoint import checkpoint as CK
from repro_torch.data import (PrefetchIterator, SyntheticLMDataset,
                              make_batch_iter)

torch.set_num_threads(1)


@pytest.mark.parametrize("vocab,seq,batch,seed", [
    (256, 32, 8, 0), (128256, 64, 2, 3), (50, 1, 1, 7)])
def test_batches_equal_the_reference(vocab, seq, batch, seed):
    ours = SyntheticLMDataset(vocab, seq, batch, seed=seed)
    ref = JDataset(vocab, seq, batch, seed=seed)
    for step in (0, 1, 17, 10_000):
        got, want = ours.batch_at(step), ref.batch_at(step)
        for k in ("tokens", "labels"):
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])


def test_batch_iter_places_int64_tensors():
    ds = SyntheticLMDataset(256, 16, 4)
    got = list(make_batch_iter(ds, 3, 4, device="cpu"))
    want = list(j_batch_iter(JDataset(256, 16, 4), 3, 4))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for k in ("tokens", "labels"):
            assert g[k].dtype == torch.int64 and g[k].device.type == "cpu"
            np.testing.assert_array_equal(g[k].numpy(), w[k])


def test_batch_iter_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None is CUDA there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_batch_iter(SyntheticLMDataset(8, 4, 1), 0, 1)


def test_prefetch_propagates_the_producer_error():
    def gen():
        yield 1
        yield 2
        raise ValueError("producer failed")

    it = PrefetchIterator(gen(), depth=1)
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(ValueError, match="producer failed"):
        next(it)
    assert list(PrefetchIterator(iter(range(5)))) == [0, 1, 2, 3, 4]


def _tree():
    rng = np.random.default_rng(0)
    return {"params": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                       "b": rng.standard_normal(4).astype(np.float32),
                       "emb": {"table": rng.standard_normal((5, 2))
                               .astype(np.float32)}},
            "opt": {"step": np.int32(7),
                    "m": {"w": rng.standard_normal((3, 4))
                          .astype(np.float32)}}}


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree))


def _equal(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _equal(got[k], want[k])
        return
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert g.dtype == np.asarray(want).dtype
    np.testing.assert_array_equal(g, np.asarray(want))


def test_round_trip_and_latest_step(tmp_path):
    d = str(tmp_path)
    assert latest_step(d) is None
    tree = _torch_tree(_tree())
    tree["params"]["half"] = torch.tensor([1.5, -2.25]).to(torch.bfloat16)
    for step in (3, 12):
        out = save_checkpoint(d, step, tree)
        assert os.path.basename(out) == f"step_{step:08d}"
    os.makedirs(os.path.join(d, "step_00000099.tmp"))     # never finished
    assert latest_step(d) == 12
    got = restore_checkpoint(d, 12, tree, device="cpu")
    half = got["params"].pop("half")
    assert half.dtype == torch.bfloat16
    assert torch.equal(half, tree["params"].pop("half"))
    _equal(got, tree)
    man = json.load(open(os.path.join(d, "step_00000012", "manifest.json")))
    assert man["n_leaves"] == 6 and man["step"] == 12
    # sorted-key order: opt.m.w, opt.step, params.b, params.emb.table, ...
    assert [tuple(x["shape"]) for x in man["leaves"]] == [
        (3, 4), (), (4,), (5, 2), (2,), (3, 4)]
    with pytest.raises(ValueError, match="leaf count"):
        restore_checkpoint(d, 12, {"params": tree["params"]}, device="cpu")


def test_async_checkpointer_keeps_the_newest(tmp_path):
    d = str(tmp_path)
    ck = AsyncCheckpointer(d, keep=3)
    w = torch.zeros(4)
    for step in range(1, 7):
        w += 1                                 # updated in place after save
        ck.save(step, {"w": w})
    ck.wait()
    assert sorted(os.listdir(d)) == [f"step_{s:08d}" for s in (4, 5, 6)]
    for s in (4, 5, 6):
        got = restore_checkpoint(d, s, {"w": w}, device="cpu")["w"]
        np.testing.assert_array_equal(got.numpy(), np.full(4, float(s)))


@pytest.mark.parametrize("compressed", [True, False])
def test_reference_checkpoint_restores_in_the_port(tmp_path, monkeypatch,
                                                   compressed):
    monkeypatch.setattr(JCK, "_Z", compressed)
    tree = _tree()
    JCK.save_checkpoint(str(tmp_path), 5, jax.tree.map(jnp.asarray, tree))
    man = json.load(open(tmp_path / "step_00000005" / "manifest.json"))
    assert man["zstd"] is compressed
    got = restore_checkpoint(str(tmp_path), 5, _torch_tree(tree),
                             device="cpu")
    _equal(got, tree)


@pytest.mark.parametrize("compressed", [True, False])
def test_port_checkpoint_restores_in_the_reference(tmp_path, monkeypatch,
                                                   compressed):
    monkeypatch.setattr(CK, "_Z", compressed)
    monkeypatch.setattr(JCK, "_Z", compressed)    # it reads by its module
    tree = _tree()
    save_checkpoint(str(tmp_path), 9, _torch_tree(tree))
    man = json.load(open(tmp_path / "step_00000009" / "manifest.json"))
    assert man["zstd"] is compressed
    got = JCK.restore_checkpoint(str(tmp_path), 9, tree)
    _equal(got, tree)


def test_compressed_checkpoint_without_zstandard_names_it(tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(CK, "_Z", True)
    save_checkpoint(str(tmp_path), 1, {"w": torch.ones(3)})
    monkeypatch.setattr(CK, "zstd", None)
    with pytest.raises(RuntimeError, match="zstandard"):
        restore_checkpoint(str(tmp_path), 1, {"w": torch.ones(3)},
                           device="cpu")
    monkeypatch.setattr(CK, "_Z", False)           # an uncompressed one reads
    save_checkpoint(str(tmp_path), 2, {"w": torch.ones(3)})
    got = restore_checkpoint(str(tmp_path), 2, {"w": torch.ones(3)},
                             device="cpu")
    np.testing.assert_array_equal(got["w"].numpy(), np.ones(3))


def test_restore_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None is CUDA there")
    save_checkpoint(str(tmp_path), 1, {"w": torch.ones(2)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        restore_checkpoint(str(tmp_path), 1, {"w": torch.ones(2)})
