"""The port's checkpoints and score package against the JAX package's (CPU).

- Deploy tier: ``save_checkpoint`` writes the bytes of
  ``flax.serialization.msgpack_serialize`` for the same payload, each side's
  ``load_checkpoint`` reads the other's file, and ``BestLastCheckpointer``
  names, replaces and falls back as the reference's does.
- Resume tier: ``state.npz`` written by either side restores into the
  other's train state (Adam's count, mu and nu, a schedule's count, the
  step and the dropout key under optax's leaf order), and the next step
  after the resume matches the other side's within 1e-6; ``Trainer.fit``
  resumes its own trajectory exactly and refuses another optimizer.
- Package: ``render_score_py`` is the reference's text, its embedded numpy
  runtime a byte-for-byte copy, and the reference's numpy scorer serves a
  package the port wrote within 1e-6 of the port's forward.
"""

import importlib.util
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from dct_tpu.checkpoint import manager as jax_manager
from dct_tpu.config import ModelConfig as JaxModelConfig
from dct_tpu.models.registry import get_model as jax_get_model
from dct_tpu.serving import score_gen as jax_score_gen
from dct_tpu.serving.score_gen import _flatten_params
from dct_tpu.train import state as jax_state
from dct_tpu.train import steps as jax_steps
from dct_tpu_torch import convert
from dct_tpu_torch.checkpoint import manager, msgpack
from dct_tpu_torch.config import DataConfig, ModelConfig, RunConfig
from dct_tpu_torch.config import TrainConfig
from dct_tpu_torch.models.registry import get_model
from dct_tpu_torch.serving import score_gen
from dct_tpu_torch.tracking.client import LocalTracking
from dct_tpu_torch.train import state as port_state
from dct_tpu_torch.train import steps
from dct_tpu_torch.train.trainer import Trainer
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mlp(seed=0, hidden=16, dropout=0.0):
    model = get_model(ModelConfig(name="weather_mlp", hidden_dim=hidden,
                                  dropout=dropout), input_dim=5, device="cpu")
    convert.load_flax_weights(model, convert.init_flax_weights(model, seed))
    return model


def _meta():
    import dataclasses

    meta = {**dataclasses.asdict(ModelConfig(hidden_dim=16)),
            "model": "weather_mlp", "input_dim": 5,
            "feature_names": [f"c{i}_norm" for i in range(5)]}
    meta.pop("name")
    return meta


def _jax_tree(model) -> dict:
    """The flax ``{"params": tree}`` of a port model's weights."""
    from flax.traverse_util import unflatten_dict

    flat = convert.flax_weights(model)
    return {"params": unflatten_dict({tuple(k.split("/")): v
                                      for k, v in flat.items()})}


# ------------------------------------------------------------ deploy tier


def test_msgpack_codec_is_flax_byte_for_byte():
    rng = np.random.default_rng(0)
    payload = {
        "meta": {"z": 1, "a": None, "neg": [-1, -33, -200, -70000, -2**40],
                 "big": [200, 70000, 2**40], "f": 0.25, "t": True,
                 "s": "x" * 40, "long": "y" * 300, "np": np.float32(2.5),
                 "keys": {str(i): i for i in range(20)}},
        "params": {"w": rng.standard_normal((70, 3)).astype(np.float32),
                   "i": np.arange(5, dtype=np.int32),
                   "one": np.zeros((1,), np.float32), "s": np.array(3.0)},
    }
    data = msgpack.serialize(payload)
    assert data == serialization.msgpack_serialize(payload)
    got = msgpack.restore(data)
    ref = serialization.msgpack_restore(data)
    assert got["meta"] == ref["meta"]
    for k, v in ref["params"].items():
        assert np.array_equal(got["params"][k], v)
        assert got["params"][k].dtype == v.dtype
    with pytest.raises(TypeError):
        msgpack.serialize({"t": (1, 2)})


def test_save_checkpoint_bytes_are_the_reference_bytes(tmp_path):
    model = _mlp(1)
    meta = _meta()
    path = manager.save_checkpoint(str(tmp_path / "p.ckpt"), model, meta)
    want = serialization.msgpack_serialize(
        {"meta": meta, "params": _jax_tree(model)})
    with open(path, "rb") as f:
        assert f.read() == want
    ref = jax_manager.save_checkpoint(str(tmp_path / "r.ckpt"),
                                      _jax_tree(model), meta)
    with open(ref, "rb") as f:
        assert f.read() == want


def test_checkpoints_cross_load_both_ways(tmp_path):
    model = _mlp(2)
    meta = _meta()
    ours = manager.save_checkpoint(str(tmp_path / "p.ckpt"), model, meta)
    theirs = jax_manager.save_checkpoint(str(tmp_path / "r.ckpt"),
                                         _jax_tree(model), meta)
    for got_params, got_meta in (jax_manager.load_checkpoint(ours),
                                 manager.load_checkpoint(theirs)):
        assert got_meta == meta
        flat = _flatten_params(got_params["params"])
        want = convert.flax_weights(model)
        assert sorted(flat) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(flat[k], want[k])
    loaded = _mlp(9)
    convert.load_flax_weights(
        loaded, manager.flatten_tree(manager.load_checkpoint(theirs)[0][
            "params"]))
    for a, b in zip(loaded.parameters(), model.parameters()):
        assert torch.equal(a, b)


def test_best_last_names_and_fallback_match_reference(tmp_path):
    model = _mlp(3)
    tree = _jax_tree(model)
    ours = manager.BestLastCheckpointer(str(tmp_path / "p"))
    theirs = jax_manager.BestLastCheckpointer(str(tmp_path / "r"))
    for epoch, vl in enumerate([0.5, 0.4, 0.45, 0.4, 0.123]):
        metrics = {"val_loss": vl, "val_acc": 0.8}
        a = ours.update(epoch=epoch, metrics=metrics, params=model,
                        meta=_meta())
        b = theirs.update(epoch=epoch, metrics=metrics, params=tree,
                          meta=_meta())
        assert a == b
        assert sorted(os.listdir(tmp_path / "p")) == sorted(
            os.listdir(tmp_path / "r"))
        assert os.path.basename(ours.best_model_path) == os.path.basename(
            theirs.best_model_path)
        for name in os.listdir(tmp_path / "p"):
            with open(tmp_path / "p" / name, "rb") as f, \
                    open(tmp_path / "r" / name, "rb") as g:
                assert f.read() == g.read(), name
    assert os.path.basename(ours.best_model_path) == "weather-best-04-0.12.ckpt"
    assert ours.last_path.endswith("last.ckpt")


# ------------------------------------------------------------ resume tier

OPTIMIZERS = [
    dict(optimizer="adam"),
    dict(optimizer="adamw", weight_decay=0.01, grad_clip_norm=0.5),
    dict(optimizer="sgd", momentum=0.9),
    dict(optimizer="lion", weight_decay=0.01),
    dict(optimizer="adam", schedule=dict(schedule="cosine", warmup_steps=2,
                                         decay_steps=10)),
]


def _batch(seed, b=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 5)).astype(np.float32)
    y = rng.integers(0, 2, b).astype(np.int32)
    w = np.ones(b, np.float32)
    w[-2:] = 0.0
    return x, y, w


def _pair(kw):
    """(reference state, port state) of an MLP from the same weights and
    optimizer config."""
    kw = dict(kw)
    sched = kw.pop("schedule", None)
    lr = 0.01
    jmodel = jax_get_model(JaxModelConfig(hidden_dim=16, dropout=0.0),
                           input_dim=5, compute_dtype=jnp.float32)
    jsched = (jax_state.make_lr_schedule(lr, **sched) if sched else None)
    jst = jax_state.create_train_state(jmodel, input_dim=5, lr=lr, seed=4,
                                       lr_schedule=jsched, **kw)
    model = _mlp()
    pst = port_state.create_train_state(
        model, input_dim=5, lr=lr, seed=4,
        lr_schedule=(port_state.make_lr_schedule(lr, **sched)
                     if sched else None), **kw)
    convert.load_flax_weights(model, _flatten_params(
        jax.device_get(jst.params["params"])))
    return jst, pst


def _port_flat(pst):
    return convert.flax_weights(pst.model)


def _jax_flat(jst):
    return _flatten_params(jax.device_get(jst.params["params"]))


def _close(port_flat, jax_flat, tol):
    for k, v in jax_flat.items():
        err = np.abs(port_flat[k] - v).max() / max(np.abs(v).max(), 1e-30)
        assert err <= tol, (k, err)


@pytest.mark.parametrize("kw", OPTIMIZERS,
                         ids=["adam", "adamw_clip", "sgd_momentum", "lion",
                              "adam_cosine"])
def test_resume_tier_cross_loads_both_ways(tmp_path, kw):
    jst, pst = _pair(kw)
    jstep = jax_steps.make_train_step(donate=False)
    pstep = steps.make_train_step()
    # Reference trains two steps and saves; the port resumes.
    for seed in (1, 2):
        jst, _ = jstep(jst, *map(jnp.asarray, _batch(seed)))
    jax_manager.TrainStateCheckpointer(str(tmp_path / "j")).save(
        jst, meta={"epochs_completed": 1})
    ours = manager.TrainStateCheckpointer(str(tmp_path / "j"))
    assert ours.load_meta() == {"epochs_completed": 1}
    pst = ours.restore(pst)
    assert pst.step == 2
    _close(_port_flat(pst), _jax_flat(jst), 0.0)
    jst, _ = jstep(jst, *map(jnp.asarray, _batch(3)))
    pst, _ = pstep(pst, *_batch(3))
    _close(_port_flat(pst), _jax_flat(jst), 1e-6)
    # The port saves; the reference resumes from the port's file.
    manager.TrainStateCheckpointer(str(tmp_path / "p")).save(
        pst, meta={"epochs_completed": 2})
    template = _pair(kw)[0]
    restored = jax_manager.TrainStateCheckpointer(
        str(tmp_path / "p")).restore(template)
    assert int(restored.step) == 3
    theirs = jax.tree.leaves(
        {"opt_state": restored.opt_state, "params": restored.params,
         "rng": restored.rng, "step": restored.step})
    mine = manager.state_leaves(pst)
    assert len(theirs) == len(mine)
    for a, b in zip(mine[:-2], theirs[:-2]):  # the rng key is the port's
        np.testing.assert_array_equal(a, np.asarray(b))
    restored, _ = jstep(restored, *map(jnp.asarray, _batch(4)))
    pst, _ = pstep(pst, *_batch(4))
    _close(_port_flat(pst), _jax_flat(restored), 1e-6)
    layout = json.load(open(tmp_path / "p" / "state" / "layout.json"))
    ref_layout = json.load(open(tmp_path / "j" / "state" / "layout.json"))
    assert set(layout) == set(ref_layout)
    assert [e["shape"] for e in layout["leaves"]] == [
        e["shape"] for e in ref_layout["leaves"]]


def test_resume_refuses_a_state_of_another_shape(tmp_path):
    jst, pst = _pair(dict(optimizer="adam"))
    manager.TrainStateCheckpointer(str(tmp_path)).save(pst)
    _, sgd = _pair(dict(optimizer="sgd", momentum=0.9))
    with pytest.raises(KeyError, match="does not match"):
        manager.TrainStateCheckpointer(str(tmp_path)).restore(sgd)


def test_save_async_snapshots_before_the_next_step(tmp_path, monkeypatch):
    """save_async copies every leaf before it returns: the next step
    updates params and moments in place (on the CPU as well, where
    ``.numpy()`` shares the tensor's storage) and must not reach the file
    the worker thread writes."""
    _, pst = _pair(dict(optimizer="adam"))
    pstep = steps.make_train_step()
    pst, _ = pstep(pst, *_batch(1))
    want = [a.copy() for a in manager.state_leaves(pst)]
    ckptr = manager.TrainStateCheckpointer(str(tmp_path))
    publish, gate = ckptr._publish, threading.Event()

    def held(*args):
        assert gate.wait(60)
        return publish(*args)

    monkeypatch.setattr(ckptr, "_publish", held)
    ckptr.save_async(pst, meta={"epochs_completed": 1})
    pst, _ = pstep(pst, *_batch(2))
    gate.set()
    ckptr.wait()
    moved = manager.state_leaves(pst)
    with np.load(tmp_path / "state" / "state.npz") as f:
        got = [f[str(i)] for i in range(len(want))]
    for a, b, c in zip(got, want, moved):
        np.testing.assert_array_equal(a, b)
    assert sum(not np.array_equal(b, c) for b, c in zip(want, moved)) > 4


def _fit_cfg(processed_dir, models_dir, epochs, resume=False, **train):
    return RunConfig(
        data=DataConfig(processed_dir=processed_dir, models_dir=models_dir),
        model=ModelConfig(name="weather_mlp", dropout=0.2),
        train=TrainConfig(epochs=epochs, batch_size=16, bf16_compute=False,
                          resume=resume, **train))


def test_fit_resume_continues_the_trajectory(processed_dir, tmp_path):
    """2 epochs, then a resumed run of 1 more, equal a 3-epoch run
    (dropout on: the masks follow the restored step and key)."""
    tracker = LocalTracking(root=str(tmp_path / "r"))
    full = Trainer(_fit_cfg(processed_dir, str(tmp_path / "a"), 3),
                   device="cpu", tracker=tracker).fit()
    Trainer(_fit_cfg(processed_dir, str(tmp_path / "b"), 2), device="cpu",
            tracker=tracker).fit()
    resumed = Trainer(_fit_cfg(processed_dir, str(tmp_path / "b"), 1,
                               resume=True),
                      device="cpu", tracker=tracker).fit()
    assert [h["epoch"] for h in resumed.history] == [2]
    assert resumed.history[0]["val_loss"] == full.history[2]["val_loss"]
    for a, b in zip(resumed.state.params, full.state.params):
        assert torch.equal(a, b)
    meta = manager.TrainStateCheckpointer(
        str(tmp_path / "b" / "train_state" / "p0")).load_meta()
    assert meta == {"epochs_completed": 3, "target_epochs": 3,
                    "optimizer": {"name": "adam", "momentum": 0.0,
                                  "weight_decay": 0.0}}
    with pytest.raises(RuntimeError, match="Resume refused"):
        Trainer(_fit_cfg(processed_dir, str(tmp_path / "b"), 1, resume=True,
                         weight_decay=0.01),
                device="cpu", tracker=tracker).fit()


# ------------------------------------------------------------ the package


def test_numpy_runtime_and_score_py_are_the_reference_text():
    with open(os.path.join(REPO, "dct_tpu", "serving", "runtime.py")) as f:
        ref = f.read()
    with open(os.path.join(REPO, "dct_tpu_torch", "serving",
                           "numpy_runtime.py")) as f:
        assert f.read() == ref
    assert score_gen.render_score_py() == jax_score_gen.render_score_py()


def test_weights_from_state_are_the_reference_weights(tmp_path):
    """A live state exports what the reference exports from the same
    params, and what its own checkpoint exports."""
    jst, pst = _pair(dict(optimizer="adam"))
    meta = _meta()
    ours, got_meta = score_gen.weights_from_state(pst, meta)
    theirs, _ = jax_score_gen.weights_from_state(jst, meta)
    path = manager.save_checkpoint(str(tmp_path / "p.ckpt"), pst.model,
                                   meta)
    saved, _ = score_gen.weights_from_checkpoint(path)
    assert got_meta == meta
    assert sorted(ours) == sorted(theirs) == sorted(saved) == [
        "b0", "b1", "w0", "w1"]
    for k in ours:
        np.testing.assert_array_equal(ours[k], np.asarray(theirs[k]))
        np.testing.assert_array_equal(ours[k], saved[k])


def _import_score(pkg_dir, monkeypatch, name):
    monkeypatch.setenv("AZUREML_MODEL_DIR", str(pkg_dir))
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg_dir, "score.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.init()
    return mod


def test_reference_scorer_serves_the_port_package(processed_dir, tmp_path,
                                                  monkeypatch):
    res = Trainer(_fit_cfg(processed_dir, str(tmp_path / "m"), 2),
                  device="cpu",
                  tracker=LocalTracking(root=str(tmp_path / "r"))).fit()
    pkg = tmp_path / "pkg"
    meta = score_gen.generate_score_package(res.best_model_path, str(pkg))
    assert sorted(os.listdir(pkg)) == ["conda.yaml", "model.npz",
                                       "model_meta.json", "score.py"]
    assert meta["model"] == "weather_mlp" and meta["input_dim"] == 5
    ours, _ = score_gen.weights_from_checkpoint(res.best_model_path)
    theirs, _ = jax_score_gen.weights_from_checkpoint(res.best_model_path)
    assert sorted(ours) == sorted(theirs) == ["b0", "b1", "w0", "w1"]
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])
    # The deployed weights are the best epoch's: load them into a model.
    params, _ = manager.load_checkpoint(res.best_model_path)
    model = get_model(ModelConfig(name="weather_mlp"), input_dim=5,
                      device="cpu")
    convert.load_flax_weights(model, manager.flatten_tree(params["params"]))
    x = np.random.default_rng(5).standard_normal((32, 5)).astype(np.float32)
    with torch.no_grad():
        want = torch.softmax(model(torch.from_numpy(x)), -1).numpy()
    score = _import_score(pkg, monkeypatch, "port_pkg_score")
    out = score.run(json.dumps({"data": x.tolist()}))
    np.testing.assert_allclose(np.asarray(out["probabilities"]), want,
                               atol=1e-6)
