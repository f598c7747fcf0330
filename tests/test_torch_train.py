"""The port's training slice against the JAX package's (CPU).

Losses, optimizers and schedules, the train and eval steps of both
transformer families, gradient accumulation, the epoch loop, dtype rules,
dropout and the data front, each held against its ``dct_tpu`` counterpart
on the same numpy inputs. Model trajectories start from a flax init carried
across with ``load_flax_weights``, with dropout 0 and T=256 so both sides
take the flash path (the JAX side through its Pallas kernels in interpret
mode, ``DCT_FLASH=interpret``; the port through the plain versions).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dct_tpu.config import ModelConfig as JaxModelConfig
from dct_tpu.data.dataset import WeatherArrays as JaxWeatherArrays
from dct_tpu.data.pipeline import BatchLoader as JaxBatchLoader
from dct_tpu.data.pipeline import contiguous_split as jax_contiguous_split
from dct_tpu.data.pipeline import train_val_split as jax_train_val_split
from dct_tpu.data.windows import make_windows as jax_make_windows
from dct_tpu.models.registry import get_model as jax_get_model
from dct_tpu.ops import losses as jax_losses
from dct_tpu.serving.score_gen import _flatten_params
from dct_tpu.train import state as jax_state
from dct_tpu.train import steps as jax_steps
from dct_tpu_torch.config import ModelConfig
from dct_tpu_torch.convert import flax_weights, load_flax_weights
from dct_tpu_torch.data.dataset import WeatherArrays
from dct_tpu_torch.data.pipeline import BatchLoader, contiguous_split
from dct_tpu_torch.data.pipeline import train_val_split
from dct_tpu_torch.data.windows import make_windows
from dct_tpu_torch.models.registry import get_model
from dct_tpu_torch.models.transformer import Dropout
from dct_tpu_torch.ops import losses
from dct_tpu_torch.parallel import sharding_rules
from dct_tpu_torch.train import state as port_state
from dct_tpu_torch.train import steps

SMALL = dict(seq_len=256, d_model=32, n_heads=2, n_layers=2, d_ff=64)
FAMILIES = [  # (family, horizon, pos_embed, n_kv_heads, attn_window)
    ("weather_transformer", 1, "sincos", 0, 0),
    ("weather_transformer_causal", 2, "rope", 1, 48),
]


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _rel(got, ref) -> float:
    got, ref = _np(got), _np(ref)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


# ---------------------------------------------------------------- losses


@pytest.mark.parametrize("shape", [(6,), (3, 5), (2, 4, 3)])
def test_losses_match_reference(shape):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((*shape, 2)).astype(np.float32)
    labels = rng.integers(0, 2, shape).astype(np.int32)
    weight = (rng.random(shape) > 0.3).astype(np.float32)
    pairs = [
        (losses.masked_cross_entropy, jax_losses.masked_cross_entropy),
        (losses.masked_accuracy, jax_losses.masked_accuracy),
        (losses.masked_binary_counts, jax_losses.masked_binary_counts),
    ]
    for port, ref in pairs:
        got = port(_t(logits), _t(labels), _t(weight))
        want = ref(jnp.asarray(logits), jnp.asarray(labels),
                   jnp.asarray(weight))
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-6)
    np.testing.assert_allclose(
        _np(losses.softmax_probs(_t(logits))),
        np.asarray(jax_losses.softmax_probs(jnp.asarray(logits))), atol=1e-7,
    )
    tp, fp, fn = (float(x) for x in losses.masked_binary_counts(
        _t(logits), _t(labels), _t(weight)))
    assert losses.precision_recall_f1(tp, fp, fn) == \
        jax_losses.precision_recall_f1(tp, fp, fn)


# ------------------------------------------------- optimizers, schedules

OPTIMIZERS = [  # make_optimizer kwargs (rate 1e-2 unless a schedule is set)
    dict(optimizer="adam"),
    dict(optimizer="adam", weight_decay=0.01),
    dict(optimizer="adamw", weight_decay=0.05),
    dict(optimizer="sgd"),
    dict(optimizer="sgd", momentum=0.9, weight_decay=0.01),
    dict(optimizer="lion", weight_decay=0.01),
    dict(optimizer="adam", grad_clip_norm=0.5),
    dict(optimizer="sgd", grad_clip_norm=100.0),
    dict(optimizer="adam", schedule=dict(schedule="constant",
                                         warmup_steps=3)),
    dict(optimizer="adam", schedule=dict(schedule="cosine", decay_steps=4,
                                         end_lr_fraction=0.1)),
    dict(optimizer="sgd", momentum=0.5, schedule=dict(
        schedule="cosine", warmup_steps=2, decay_steps=3)),
]


@pytest.mark.parametrize("cfg", OPTIMIZERS, ids=lambda c: repr(c))
def test_optimizers_match_optax(cfg):
    cfg = dict(cfg)
    sched = cfg.pop("schedule", None)
    rates = (jax_state.make_lr_schedule(1e-2, **sched),
             port_state.make_lr_schedule(1e-2, **sched)) if sched else (
                 1e-2, 1e-2)
    rng = np.random.default_rng(2)
    shapes = [(4, 3), (3,), (2, 2, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jtx = jax_state.make_optimizer(rates[0], **cfg)
    ttx = port_state.make_optimizer(rates[1], **cfg)
    jp = [jnp.asarray(p) for p in params]
    tp = [_t(p) for p in params]
    jst, tst = jtx.init(jp), ttx.init(tp)
    for _ in range(5):
        grads = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        ju, jst = jtx.update([jnp.asarray(g) for g in grads], jst, jp)
        jp = optax.apply_updates(jp, ju)
        tu, tst = ttx.update([_t(g) for g in grads], tst, tp)
        tp = [p + u for p, u in zip(tp, tu)]
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-6)


@pytest.mark.parametrize("sched", [
    dict(schedule="constant"),
    dict(schedule="constant", warmup_steps=4),
    dict(schedule="cosine", decay_steps=7, end_lr_fraction=0.2),
    dict(schedule="cosine", warmup_steps=3, decay_steps=6),
])
def test_lr_schedules_match_optax(sched):
    ref = jax_state.make_lr_schedule(3e-3, **sched)
    got = port_state.make_lr_schedule(3e-3, **sched)
    for count in range(14):
        want = float(ref(count)) if callable(ref) else ref
        value = got(count) if callable(got) else got
        assert value == pytest.approx(want, rel=1e-6, abs=1e-12)


@pytest.mark.parametrize("decay", [0.9, 0.999])
def test_adam_bias_correction_is_optaxs(decay):
    """optax's Adam divides by ``1 - decay**count`` with an int32 count, in
    f32 on the device; the port takes it on the host from its Python step
    count. The two agree bit for bit over a long run."""
    counts = np.arange(1, 3001, dtype=np.int32)
    want = np.asarray(jax.vmap(lambda c: 1 - decay**c)(jnp.asarray(counts)))
    got = np.array([port_state._bias_correction(decay, int(c))
                     for c in counts], np.float32)
    np.testing.assert_array_equal(got, want)


def test_optimizer_refusals():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_state.make_optimizer(1e-3, optimizer="adafactor")
    with pytest.raises(ValueError, match="momentum|MOMENTUM"):
        port_state.make_optimizer(1e-3, optimizer="adam", momentum=0.9)
    with pytest.raises(ValueError, match="not in"):
        port_state.make_optimizer(1e-3, optimizer="rmsprop")
    with pytest.raises(ValueError, match="decay_steps"):
        port_state.make_lr_schedule(1e-3, schedule="cosine")


# ------------------------------------------------------ model train steps


def _pair(family, horizon, pos_embed, n_kv, window, *, compute=None,
          optimizer="adam", lr=1e-3, dropout=0.0, seed=0):
    """A JAX train state and the port's, the port carrying the flax init."""
    fields = dict(SMALL, name=family, horizon=horizon, pos_embed=pos_embed,
                  n_kv_heads=n_kv, attn_window=window, dropout=dropout)
    jmodel = jax_get_model(JaxModelConfig(**fields), input_dim=5,
                           compute_dtype=compute and jnp.bfloat16)
    jst = jax_state.create_train_state(
        jmodel, input_dim=5, lr=lr, seed=seed, optimizer=optimizer,
        example_shape=(1, SMALL["seq_len"], 5),
    )
    tmodel = get_model(ModelConfig(**fields), input_dim=5, device="cpu",
                       compute_dtype=compute and torch.bfloat16)
    tst = port_state.create_train_state(tmodel, input_dim=5, lr=lr,
                                        seed=seed, optimizer=optimizer)
    load_flax_weights(tmodel, _flatten_params(jst.params["params"]))
    return jst, tst


def _batch(family, horizon, seed=3, b=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, SMALL["seq_len"], 5)).astype(np.float32)
    if family == "weather_transformer_causal":
        shape = (b, SMALL["seq_len"]) + ((horizon,) if horizon > 1 else ())
    else:
        shape = (b,)
    y = rng.integers(0, 2, shape).astype(np.int32)
    w = np.ones(b, np.float32)
    w[-1] = 0.0 if b > 2 else 1.0
    return x, y, w


def _jax_grads(jst, x, y, w):
    def loss_fn(params):
        logits = jst.apply_fn(jax_steps.cast_params_by_rules(params), x,
                              train=True, rngs={"dropout": jst.rng})
        loss_sum, count = jax_losses.masked_cross_entropy(
            logits, y, jax_steps._position_weight(logits, y, w))
        return loss_sum / jnp.maximum(count, 1.0)

    loss, grads = jax.value_and_grad(loss_fn)(jst.params)
    return float(loss), _flatten_params(grads["params"])


def _port_grads(tst, x, y, w):
    loss, grads = steps.loss_and_grads(tst, x, y, w)
    for p, g in zip(tst.params, grads):
        p.grad = g
    out = flax_weights(tst.model, grads=True)
    for p in tst.params:
        p.grad = None
    return float(loss), out


@pytest.mark.parametrize("family,horizon,pos_embed,n_kv,window", FAMILIES)
def test_three_adam_steps_match_jax(family, horizon, pos_embed, n_kv, window,
                                    monkeypatch):
    monkeypatch.setenv("DCT_FLASH", "interpret")
    jst, tst = _pair(family, horizon, pos_embed, n_kv, window)
    x, y, w = _batch(family, horizon)
    jloss, jgrads = _jax_grads(jst, x, y, w)
    tloss, tgrads = _port_grads(tst, x, y, w)
    assert tloss == pytest.approx(jloss, rel=1e-5)
    assert set(tgrads) == set(jgrads)
    for key in jgrads:  # step-1 gradients: 1e-4 of each one's max
        assert _rel(tgrads[key], jgrads[key]) <= 1e-4, key
    jstep = jax_steps.make_train_step(donate=False, with_grad_norm=True)
    tstep = steps.make_train_step(with_grad_norm=True)
    for i in range(3):
        xi, yi, wi = _batch(family, horizon, seed=10 + i)
        jst, jm = jstep(jst, jnp.asarray(xi), jnp.asarray(yi),
                        jnp.asarray(wi))
        tst, tm = tstep(tst, xi, yi, wi)
        assert float(tm["train_loss"]) == pytest.approx(
            float(jm["train_loss"]), rel=1e-5)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-4)
    assert tst.step == int(jst.step) == 3
    # Adam's first updates are close to lr * sign(g): it amplifies gradient
    # noise, so parameters are compared at 1e-4 absolute (a tenth of lr),
    # not at the gradients' 1e-4 relative. Without RoPE, the k bias of every
    # qkv_proj has an analytically zero gradient (a constant added to every
    # key shifts a score row uniformly, which softmax ignores): both sides'
    # gradients there are rounding noise, which Adam turns into steps of up
    # to ~lr/10 with independent signs. Those columns are held to that: noise-level
    # gradients and parameters within 3 lr of each other.
    want = _flatten_params(jst.params["params"])
    kcols = _k_bias_columns(SMALL["n_heads"], n_kv or SMALL["n_heads"],
                            SMALL["d_model"] // SMALL["n_heads"])
    for key, value in flax_weights(tst.model).items():
        ref = np.asarray(want[key])
        if key.endswith("qkv_proj/bias") and pos_embed != "rope":
            scale = np.abs(jgrads[key]).max()
            assert np.abs(jgrads[key][kcols]).max() <= 1e-5 * scale
            assert np.abs(tgrads[key][kcols]).max() <= 1e-5 * scale
            np.testing.assert_allclose(value[kcols], ref[kcols], atol=3e-3)
            value, ref = np.delete(value, kcols), np.delete(ref, kcols)
        np.testing.assert_allclose(value, ref, atol=1e-4, err_msg=key)


def _k_bias_columns(n_heads, n_kv, head_dim):
    """Columns of the fused qkv bias that belong to k: per KV group, its
    ``n_heads // n_kv`` q heads, then one k head, then one v head."""
    hg = n_heads // n_kv
    return np.concatenate([
        np.arange(head_dim) + (g * (hg + 2) + hg) * head_dim
        for g in range(n_kv)
    ])


def test_bf16_compute_step_matches_jax(monkeypatch):
    monkeypatch.setenv("DCT_FLASH", "interpret")
    family, horizon, pos_embed, n_kv, window = FAMILIES[1]
    jst, tst = _pair(family, horizon, pos_embed, n_kv, window, compute="bf16")
    assert tst.model.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in tst.params)
    x, y, w = _batch(family, horizon)
    jloss, jgrads = _jax_grads(jst, x, y, w)
    tloss, tgrads = _port_grads(tst, x, y, w)
    assert tloss == pytest.approx(jloss, rel=2e-2)
    for key in jgrads:
        assert _rel(tgrads[key], jgrads[key]) <= 2e-2, key


def test_dtype_rules_match_jax_cast(monkeypatch):
    monkeypatch.setenv("DCT_FLASH", "interpret")
    monkeypatch.setenv("DCT_DTYPE_RULES", ".*=bf16")
    family, horizon, pos_embed, n_kv, window = FAMILIES[0]
    jst, tst = _pair(family, horizon, pos_embed, n_kv, window)
    x, y, w = _batch(family, horizon)
    jloss, jgrads = _jax_grads(jst, x, y, w)
    tloss, tgrads = _port_grads(tst, x, y, w)
    assert tloss == pytest.approx(jloss, rel=2e-2)
    for key in jgrads:  # bf16 weights, f32 arithmetic: one bf16 rounding
        assert _rel(tgrads[key], jgrads[key]) <= 2e-2, key
    # The rules change the forward: not the masters' dtype.
    monkeypatch.delenv("DCT_DTYPE_RULES")
    plain_loss, _ = _port_grads(tst, x, y, w)
    assert plain_loss != tloss
    assert all(p.dtype == torch.float32 for p in tst.params)


def test_dtype_rules_grammar_and_matching(monkeypatch):
    from dct_tpu.parallel import sharding_rules as jax_rules

    for text in ("kernel", ".*=f64", "(=bf16"):
        with pytest.raises(ValueError):
            sharding_rules.parse_dtype_rules(text)
    spec = "qkv_proj/kernel=bf16; params/head=f16;.*=f32"
    assert sharding_rules.parse_dtype_rules(spec) == \
        jax_rules.parse_dtype_rules(spec)
    monkeypatch.delenv("DCT_DTYPE_RULES", raising=False)
    assert sharding_rules.dtype_rules() == ()
    model = get_model(ModelConfig(name="weather_transformer", **SMALL),
                      input_dim=5, device="cpu")
    assert sharding_rules.cast_params_by_rules(model) is None
    monkeypatch.setenv("DCT_DTYPE_RULES", spec)
    assert sharding_rules.dtype_rules() == jax_rules.dtype_rules()
    cast = sharding_rules.cast_params_by_rules(model)
    assert cast["block_0.attn.qkv_proj.weight"].dtype == torch.bfloat16
    assert cast["block_0.attn.qkv_proj.bias"].dtype == torch.float32
    assert cast["head.weight"].dtype == torch.float16
    assert cast["block_1.ln_ffn.weight"].dtype == torch.float32


def test_accum_steps_equal_one_step_on_the_whole_batch():
    """SGD makes the update linear in the gradient, so the two paths'
    parameters agree as tightly as their gradients."""
    family, horizon, pos_embed, n_kv, window = FAMILIES[1]
    _, one = _pair(family, horizon, pos_embed, n_kv, window,
                   optimizer="sgd", lr=0.5)
    _, acc = _pair(family, horizon, pos_embed, n_kv, window,
                   optimizer="sgd", lr=0.5)
    x, y, w = _batch(family, horizon, b=4)
    one, m1 = steps.make_train_step(with_grad_norm=True)(one, x, y, w)
    acc, m2 = steps.make_train_step(accum_steps=2, with_grad_norm=True)(
        acc, x, y, w)
    assert float(m2["train_loss"]) == pytest.approx(float(m1["train_loss"]),
                                                    rel=1e-6)
    assert float(m2["grad_norm"]) == pytest.approx(float(m1["grad_norm"]),
                                                   rel=1e-5)
    for a, b in zip(acc.params, one.params):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-6)
    with pytest.raises(ValueError, match="microbatches"):
        steps.make_train_step(accum_steps=3)(acc, x, y, w)


def test_epoch_step_is_s_per_batch_steps():
    """The epoch loop is the per-batch step in order, with dropout on: the
    same masks (seeded by the step) and bit-identical results."""
    family, horizon, pos_embed, n_kv, window = FAMILIES[0]
    _, a = _pair(family, horizon, pos_embed, n_kv, window, dropout=0.2)
    _, b = _pair(family, horizon, pos_embed, n_kv, window, dropout=0.2)
    batches = [_batch(family, horizon, seed=20 + i, b=3) for i in range(3)]
    xs, ys, ws = (np.stack(z) for z in zip(*batches))
    a, losses, gnorms = steps.make_epoch_train_step(with_grad_norms=True)(
        a, xs, ys, ws)
    step = steps.make_train_step(with_grad_norm=True)
    for i, (x, y, w) in enumerate(batches):
        b, m = step(b, x, y, w)
        assert torch.equal(losses[i], m["train_loss"])
        assert torch.equal(gnorms[i], m["grad_norm"])
    for pa, pb in zip(a.params, b.params):
        assert torch.equal(pa, pb)
    # Fused train + eval: the same epoch, then the eval sums.
    _, c = _pair(family, horizon, pos_embed, n_kv, window, dropout=0.2)
    c, losses2, sums = steps.make_epoch_train_eval_step()(
        c, xs, ys, ws, xs[:1], ys[:1], ws[:1])
    assert torch.equal(losses2, losses)
    want = steps.make_eval_step()(a, xs[0], ys[0], ws[0])
    assert all(torch.equal(s, t) for s, t in zip(sums, want))


@pytest.mark.parametrize("family,horizon,pos_embed,n_kv,window", FAMILIES)
def test_eval_sums_match_jax(family, horizon, pos_embed, n_kv, window,
                             monkeypatch):
    monkeypatch.setenv("DCT_FLASH", "interpret")
    jst, tst = _pair(family, horizon, pos_embed, n_kv, window, dropout=0.2)
    x, y, w = _batch(family, horizon, b=3)  # the last row is padding
    want = jax_steps.make_eval_step()(jst, jnp.asarray(x), jnp.asarray(y),
                                      jnp.asarray(w))
    got = steps.make_eval_step()(tst, x, y, w)
    assert len(got) == 6
    for g, r in zip(got, want):
        assert float(g) == pytest.approx(float(r), rel=1e-5, abs=1e-6)
    assert not tst.model.training


# ---------------------------------------------------------------- dropout


def test_dropout_rate_and_modes():
    drop = Dropout(0.25)
    x = torch.ones(400, 500)
    assert torch.equal(drop.eval()(x, None), x)
    drop.train()
    with pytest.raises(ValueError, match="dropout_key"):
        drop(x, None)
    y = drop(x, (7, 0, 0, 0))
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.01
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert torch.equal(drop(x, (7, 0, 0, 0)), y)  # same key, same mask
    assert not torch.equal(drop(x, (7, 1, 0, 0)), y)  # next step differs
    assert torch.equal(Dropout(0.0).train()(x, None), x)


def test_remat_recompute_reproduces_the_dropout_masks():
    family, horizon, pos_embed, n_kv, window = FAMILIES[1]
    fields = dict(SMALL, name=family, horizon=horizon, pos_embed=pos_embed,
                  n_kv_heads=n_kv, attn_window=window, dropout=0.3)
    states = []
    for remat in (False, True):
        model = get_model(ModelConfig(**fields, remat=remat), input_dim=5,
                          device="cpu")
        states.append(port_state.create_train_state(model, input_dim=5,
                                                    lr=1e-3, seed=4))
    x, y, w = _batch(family, horizon)
    (l0, g0), (l1, g1) = (steps.loss_and_grads(s, x, y, w) for s in states)
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7)
    # Dropout is on: the same state without it gives another loss.
    states[0].model.block_0.drop.rate = 0.0
    assert not torch.equal(steps.loss_and_grads(states[0], x, y, w)[0], l0)


def test_create_train_state_is_seeded_and_checked():
    cfg = ModelConfig(name="weather_transformer", **SMALL)
    a = port_state.create_train_state(
        get_model(cfg, input_dim=5, device="cpu"), input_dim=5, lr=1e-3,
        seed=3, example_shape=(1, SMALL["seq_len"], 5))
    b = port_state.create_train_state(
        get_model(cfg, input_dim=5, device="cpu"), input_dim=5, lr=1e-3,
        seed=3)
    assert all(torch.equal(p, q) for p, q in zip(a.params, b.params))
    assert (a.step, a.seed, a.rng) == (0, 3, b.rng)
    with pytest.raises(ValueError, match="input features"):
        port_state.create_train_state(
            get_model(cfg, input_dim=5, device="cpu"), input_dim=4, lr=1e-3,
            seed=3)
    with pytest.raises(TypeError, match="f32 master"):
        port_state.create_train_state(
            get_model(cfg, input_dim=5, device="cpu", dtype=torch.bfloat16),
            input_dim=5, lr=1e-3, seed=3)


# ------------------------------------------------------------ data front


def _rows(n=700, seed=5):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((n, 5)).astype(np.float32)
    labels = rng.integers(0, 2, n).astype(np.int32)
    names = [f"f{i}_norm" for i in range(5)]
    return (WeatherArrays(feats, labels, names),
            JaxWeatherArrays(feats, labels, names))


@pytest.mark.parametrize("per_position,horizon", [
    (False, 1), (True, 1), (True, 3),
])
def test_windows_split_and_loader_match_jax(per_position, horizon):
    port_rows, jax_rows = _rows()
    seq = 64
    got = make_windows(port_rows, seq, per_position_labels=per_position,
                       horizon=horizon)
    want = jax_make_windows(jax_rows, seq, per_position_labels=per_position,
                            horizon=horizon)
    assert len(got) == len(want) and got.input_dim == want.input_dim
    np.testing.assert_array_equal(got.features, want.features)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.labels.dtype == np.int32
    gap = seq + horizon - 1
    split = contiguous_split(len(got), val_fraction=0.2, gap=gap)
    for a, b in zip(split, jax_contiguous_split(len(want), val_fraction=0.2,
                                                gap=gap)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(train_val_split(len(got), val_fraction=0.3, seed=9),
                    jax_train_val_split(len(want), val_fraction=0.3, seed=9)):
        np.testing.assert_array_equal(a, b)
    for kw in (dict(global_batch=48, shuffle=True, seed=2),
               dict(global_batch=48, shuffle=False, num_processes=2,
                    process_id=1)):
        port = BatchLoader(got, split[0], **kw)
        ref = JaxBatchLoader(want, split[0], **kw)
        assert port.num_batches == ref.num_batches
        for a, b in zip(port.epoch_stacked(1), ref.epoch_stacked(1)):
            np.testing.assert_array_equal(a, b)


def test_window_refusals():
    port_rows, _ = _rows(n=40)
    with pytest.raises(ValueError, match="per_position_labels"):
        make_windows(port_rows, 8, horizon=2)
    with pytest.raises(ValueError, match="rows"):
        make_windows(port_rows, 40)
    with pytest.raises(ValueError, match="divisible"):
        BatchLoader(port_rows, np.arange(10), global_batch=5, shuffle=False,
                    num_processes=2)
