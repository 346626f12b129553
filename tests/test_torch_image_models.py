"""The port's image families against the JAX package on the CPU: `MLP`,
`ConvNet`, a mini `ResNet` (num_filters 8; BasicBlock and Bottleneck;
with and without space-to-depth; odd and even image sizes, so SAME pads
asymmetrically at stride 2) and a tiny `ViT` (cls and mean pooling),
with the JAX parameters carried across by `convert`: the forward in
train and eval mode, the BatchNorm running statistics after a training
forward, one `Trainer` step (loss, parameters and `batch_stats`), and
the converters both ways.

Tolerances, with their reasons:
- f32 compute (`compute_dtype=float32`): the same products summed in
  another order, 1e-5 relative + 1e-5 absolute on logits (2e-5 for the
  ResNets, whose BatchNorms divide by batch standard deviations, and
  whose JAX statistics use E[x^2] - E[x]^2 where torch's use the
  centred sum); running statistics 1e-5; one SGD step's parameters
  1e-5.
- bf16 compute, where bf16 is the point: logits within 3e-2 of their
  scale (a few bf16 roundings, 2^-9 each, in every layer; the two
  frameworks round the bias add, LayerNorm's scale and the residual
  adds at other points).
- The converters: bit for bit both ways.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cloud_tpu.models import mnist as jmnist
from cloud_tpu.models import resnet as jresnet
from cloud_tpu.models import vit as jvit
from cloud_tpu.training import trainer as jtrainer
from cloud_tpu_torch.models import _layers, convert
from cloud_tpu_torch.models import mnist as tmnist
from cloud_tpu_torch.models import resnet as tresnet
from cloud_tpu_torch.models import vit as tvit
from cloud_tpu_torch.training import trainer as ttrainer

F32 = dict(compute_dtype=jnp.float32)
T32 = dict(compute_dtype=torch.float32)


def _images(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _init(jmodel, x, **kw):
    return jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x), **kw)


def _port(tmodel, variables):
    tmodel.load_state_dict(convert.image_params_from_flax(
        jax.tree_util.tree_map(np.asarray, dict(variables))))
    return tmodel


def _logits(tmodel, x, **kw):
    with torch.no_grad():
        return tmodel(torch.tensor(x), **kw).numpy()


def _scale_close(got, want, share):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=share * np.abs(want).max())


# -- same padding ---------------------------------------------------------

@pytest.mark.parametrize("size,k,s", [(224, 7, 2), (56, 3, 2), (112, 3, 2),
                                      (112, 4, 1), (7, 3, 2), (9, 3, 1),
                                      (5, 1, 2)])
def test_same_pads_match_xla(size, k, s):
    """(lo, hi) as lax's SAME: the output size and a one-hot probe
    through both convolutions land on the same positions."""
    lo, hi = _layers.same_pads(size, k, s)
    pads = jax.lax.padtype_to_pads((size,), (k,), (s,), "SAME")
    assert (lo, hi) == tuple(pads[0])


@pytest.mark.parametrize("size,k,s", [(9, 3, 2), (10, 3, 2), (10, 7, 2),
                                      (9, 1, 2), (10, 4, 1), (9, 3, 1)])
def test_conv_same_matches_flax(size, k, s):
    x = _images((2, size, size, 3))
    conv = __import__("flax").linen.Conv(5, (k, k), strides=(s, s),
                                         dtype=jnp.float32)
    variables = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(conv.apply(variables, jnp.asarray(x)))
    w = torch.tensor(np.asarray(variables["params"]["kernel"])
                     ).permute(3, 2, 0, 1)
    b = torch.tensor(np.asarray(variables["params"]["bias"]))
    got = _layers.conv_same(torch.tensor(x).permute(0, 3, 1, 2), w, b, s,
                            torch.float32).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("size", [9, 10])
def test_max_pool_same_matches_flax(size):
    x = _images((2, size, size, 4)) - 3.0     # all negative: pads show
    want = np.asarray(__import__("flax").linen.max_pool(
        jnp.asarray(x), (3, 3), strides=(2, 2), padding="SAME"))
    got = _layers.max_pool_same(torch.tensor(x).permute(0, 3, 1, 2), 3,
                                2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)


# -- MNIST ----------------------------------------------------------------

def test_mlp_forward_matches_jax():
    x = _images((6, 28, 28))
    jm = jmnist.MLP(hidden=32, **F32)
    variables = _init(jm, x)
    tm = _port(tmnist.MLP(hidden=32, device="cpu", **T32), variables)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    np.testing.assert_allclose(_logits(tm, x), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("channels", [None, 3])
def test_convnet_forward_matches_jax(channels):
    shape = (4, 14, 14) if channels is None else (4, 14, 14, channels)
    x = _images(shape)
    jm = jmnist.ConvNet(**F32)
    variables = _init(jm, x)
    tm = _port(tmnist.ConvNet(image_size=14, in_channels=channels or 1,
                              device="cpu", **T32), variables)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    np.testing.assert_allclose(_logits(tm, x), want, rtol=1e-5, atol=1e-5)


def test_mlp_bf16_matches_jax():
    x = _images((6, 28, 28))
    jm = jmnist.MLP(hidden=64)
    variables = _init(jm, x)
    tm = _port(tmnist.MLP(hidden=64, device="cpu"), variables)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    got = _logits(tm, x)
    assert got.dtype == np.float32
    _scale_close(got, want, 3e-2)


# -- ResNet ---------------------------------------------------------------

RESNETS = {
    "basic": dict(stage_sizes=(1, 1), block="BasicBlock"),
    "bottleneck": dict(stage_sizes=(1, 2), block="BottleneckBlock"),
    "bottleneck_s2d": dict(stage_sizes=(1, 1), block="BottleneckBlock",
                           conv0_space_to_depth=True),
}


def _resnets(name, num_classes=7, compute=None):
    cfg = dict(RESNETS[name])
    block = cfg.pop("block")
    jm = jresnet.ResNet(num_classes=num_classes, num_filters=8,
                        block=getattr(jresnet, block),
                        compute_dtype=compute or jnp.float32, **cfg)
    tm = tresnet.ResNet(num_classes=num_classes, num_filters=8,
                        block=getattr(tresnet, block), device="cpu",
                        compute_dtype=torch.float32 if compute is None
                        else torch.bfloat16, **cfg)
    return jm, tm


@pytest.mark.parametrize("name,size", [
    ("basic", 33), ("bottleneck", 30), ("bottleneck_s2d", 34)])
def test_resnet_forward_and_batch_stats_match_jax(name, size):
    x = _images((4, size, size, 3))
    jm, tm = _resnets(name)
    variables = _init(jm, x, train=False)
    # Move the statistics off their init so eval mode reads real ones.
    _, moved = jm.apply(variables, jnp.asarray(x) * 2 + 1, train=True,
                        mutable=["batch_stats"])
    variables = {"params": variables["params"], **moved}
    _port(tm, variables)
    np.testing.assert_allclose(
        _logits(tm, x, train=False),
        np.asarray(jm.apply(variables, jnp.asarray(x), train=False)),
        rtol=2e-5, atol=2e-5)
    want, new = jm.apply(variables, jnp.asarray(x), train=True,
                         mutable=["batch_stats"])
    tm.train()
    got = _logits(tm, x, train=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)
    flat = convert.image_params_from_flax({"params": {},
                                           "batch_stats": new["batch_stats"]})
    state = tm.state_dict()
    for key, value in flat.items():
        np.testing.assert_allclose(state[key].numpy(), value.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=key)


def test_resnet_s2d_rejects_odd_sizes():
    _, tm = _resnets("bottleneck_s2d")
    with pytest.raises(ValueError, match="even spatial"):
        tm(torch.zeros(1, 9, 9, 3))


def test_resnet_bf16_matches_jax():
    x = _images((4, 32, 32, 3))
    jm, tm = _resnets("bottleneck", compute=jnp.bfloat16)
    variables = _init(jm, x, train=False)
    _port(tm, variables)
    want, _ = jm.apply(variables, jnp.asarray(x), train=True,
                       mutable=["batch_stats"])
    _scale_close(_logits(tm, x, train=True), np.asarray(want), 3e-2)


def test_resnet50_shapes_and_flops():
    tm = tresnet.ResNet50(device="cpu", seed=None)
    assert sum(p.numel() for p in tm.parameters()) == 25557032
    # 4.09 G multiply-adds a 224 x 224 image forward (He et al. 2016's
    # 3.8 G counts the 1x1 shortcut and head differently).
    assert tresnet.resnet_train_flops(tm, 1, 224) / 3 == pytest.approx(
        8.178e9, rel=1e-3)


# -- ViT ------------------------------------------------------------------

def _vits(pool, compute=None, dropout_rate=0.0):
    kw = dict(num_classes=5, patch_size=4, num_layers=2, num_heads=2,
              d_model=16, d_ff=32, pool=pool, dropout_rate=dropout_rate)
    jm = jvit.ViT(attention_impl="reference",
                  compute_dtype=compute or jnp.float32, **kw)
    tm = tvit.ViT(image_size=12, device="cpu",
                  compute_dtype=torch.float32 if compute is None
                  else torch.bfloat16, **kw)
    return jm, tm


@pytest.mark.parametrize("pool", ["cls", "mean"])
def test_vit_forward_matches_jax(pool):
    x = _images((3, 12, 12, 3))
    jm, tm = _vits(pool)
    variables = _init(jm, x)
    _port(tm, variables)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    np.testing.assert_allclose(_logits(tm, x), want, rtol=1e-5, atol=1e-5)
    assert tm.seq_len == 9 + (pool == "cls")


def test_vit_bf16_matches_jax():
    x = _images((3, 12, 12, 3))
    jm, tm = _vits("cls", compute=jnp.bfloat16)
    variables = _init(jm, x)
    _port(tm, variables)
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    _scale_close(_logits(tm, x), want, 3e-2)


def test_vit_rejects_indivisible_and_bad_pool():
    with pytest.raises(ValueError, match="divide"):
        tvit.ViT(image_size=13, patch_size=4, device="cpu")
    _, tm = _vits("cls")
    with pytest.raises(ValueError, match="divide"):
        tm(torch.zeros(1, 13, 12, 3))
    with pytest.raises(ValueError, match="pool"):
        tvit.ViT(pool="max", device="cpu")


def test_vit_presets():
    for fn, (layers, heads, d) in ((tvit.ViT_S16, (12, 6, 384)),
                                   (tvit.ViT_B16, (12, 12, 768))):
        m = fn(device="cpu", seed=None, num_classes=10)
        assert (m.num_layers, m.num_heads, m.d_model) == (layers, heads, d)
        assert m.seq_len == 197


# -- converters -----------------------------------------------------------

@pytest.mark.parametrize("kind", ["mlp", "convnet", "resnet", "vit"])
def test_converters_round_trip_bit_for_bit(kind):
    if kind == "mlp":
        jm, x = jmnist.MLP(hidden=16, **F32), _images((2, 28, 28))
        tm = tmnist.MLP(hidden=16, device="cpu", **T32)
        variables = _init(jm, x)
    elif kind == "convnet":
        jm, x = jmnist.ConvNet(**F32), _images((2, 28, 28))
        tm = tmnist.ConvNet(device="cpu", **T32)
        variables = _init(jm, x)
    elif kind == "resnet":
        jm, tm = _resnets("bottleneck")
        x = _images((2, 16, 16, 3))
        variables = _init(jm, x, train=False)
    else:
        jm, tm = _vits("cls")
        x = _images((2, 12, 12, 3))
        variables = _init(jm, x)
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    _port(tm, variables)
    back = convert.image_params_to_flax(tm)
    assert set(back) == set(variables)
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, value in flat_a:
        np.testing.assert_array_equal(flat_b[path], value)
    paths = {convert.image_param_path(tm, n) for n, _ in
             tm.named_parameters()}
    want = {"/".join(str(k.key) for k in p)
            for p, _ in jax.tree_util.tree_leaves_with_path(
                variables["params"])}
    assert paths == want


# -- one Trainer step -----------------------------------------------------

def _one_step(jm, tm, variables, x, y, train_kwargs, lr=0.1):
    # numpy copies: the JAX step donates (deletes) the arrays it is given.
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    jt = jtrainer.Trainer(jm, optimizer=optax.sgd(lr, momentum=0.9),
                          metrics=(), train_kwargs=train_kwargs,
                          eval_kwargs={k: False for k in train_kwargs})
    jt.build(x, variables=variables)
    jh = jt.fit(x, y, epochs=1, batch_size=len(x), shuffle=False,
                verbose=False)
    _port(tm, variables)
    tt = ttrainer.Trainer(tm, optimizer=ttrainer.make_optimizer("sgd", lr),
                          metrics=(), train_kwargs=train_kwargs,
                          eval_kwargs={k: False for k in train_kwargs})
    th = tt.fit(x, y, epochs=1, batch_size=len(x), shuffle=False,
                verbose=False)
    return jt, jh, tt, th


@pytest.mark.parametrize("name", ["basic"])
def test_resnet_trainer_step_matches_jax(name):
    x = _images((8, 17, 17, 3), seed=2)
    y = np.random.default_rng(3).integers(0, 7, size=8)
    jm, tm = _resnets(name)
    variables = _init(jm, x, train=False)
    jt, jh, tt, th = _one_step(jm, tm, variables, x, y, {"train": True})
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-5)
    want = convert.image_params_from_flax(
        {"params": jt.state.params,
         "batch_stats": jt.state.extra_vars["batch_stats"]})
    state = tm.state_dict()
    for key, value in want.items():
        np.testing.assert_allclose(state[key].numpy(), value.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    ev_j = jt.evaluate(x, y, batch_size=8, verbose=False)
    ev_t = tt.evaluate(x, y, batch_size=8, verbose=False)
    np.testing.assert_allclose(ev_t["loss"], ev_j["loss"], rtol=1e-5)
    np.testing.assert_allclose(tt.predict(x, batch_size=8),
                               np.asarray(jt.predict(x, batch_size=8)),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("kind", ["mlp", "convnet", "vit"])
def test_trainer_step_matches_jax(kind):
    rng = np.random.default_rng(4)
    if kind == "vit":
        jm, tm = _vits("mean")
        x = _images((6, 12, 12, 3))
        kwargs = {"train": True}
    elif kind == "mlp":
        jm = jmnist.MLP(hidden=16, **F32)
        tm = tmnist.MLP(hidden=16, device="cpu", **T32)
        x, kwargs = _images((6, 28, 28)), {}
    else:
        jm = jmnist.ConvNet(**F32)
        tm = tmnist.ConvNet(device="cpu", **T32)
        x, kwargs = _images((6, 28, 28)), {}
    y = rng.integers(0, 5, size=len(x))
    variables = _init(jm, x)
    jt, jh, tt, th = _one_step(jm, tm, variables, x, y, kwargs)
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-5)
    want = convert.image_params_from_flax({"params": jt.state.params})
    state = tm.state_dict()
    for key, value in want.items():
        np.testing.assert_allclose(state[key].numpy(), value.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
