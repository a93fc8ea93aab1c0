"""The on-scene trainer in the port (mpsfm_tpu_torch/extraction/nets/
train_mono.py) against the JAX package's on the CPU.

The same initial weights (the JAX package's Flax init carried across by
convert.mono_state_dict) and the same batches (numpy's generator, the JAX
package's draws):
  * _loss_fn's value and gradients against jax.value_and_grad: the loss and
    metrics within 1e-5 relative, each parameter's gradient within 1e-4 of
    its largest magnitude (float32's summation order) but the attention's
    key bias, whose gradient is 0 (the softmax over the keys does not see
    it) and so rounding only: within 1e-4 of the qkv bias' largest;
  * the schedule: optax's warmup_cosine_decay_schedule count for count (the
    first update's lr is 0);
  * 3 steps of train_mono: each step's printed metrics equal (4 decimals),
    the last step's within 1e-4 relative, 99.9% of the weights' changes
    within 1e-2 lr of the JAX package's and all within 2 lr (Adam moves
    an element whose gradient is mostly rounding by that rounding's sign:
    the key bias, which moves at most lr a step in either package);
  * a port-trained file loads in the JAX package's load_mono_params and
    predicts the port's maps within 1e-4;
  * fit_scene_prior on a rendered RGB-D directory (the INTER_AREA resize,
    the normals from the depth, the focal's canonical scaling): the same
    metrics and weights as the JAX package's.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mpsfm_tpu.extraction.nets import train_mono as jtm
from mpsfm_tpu.extraction.nets.mono import MonoViT as JMonoViT
from mpsfm_tpu.extraction.nets.mono import ViTMonoBackend as JViTMonoBackend
from mpsfm_tpu.extraction.priors import normals_from_depth
from mpsfm_tpu_torch import convert
from mpsfm_tpu_torch.extraction.nets import mono
from mpsfm_tpu_torch.extraction.nets import train_mono as ttm

NET = {"dim": 32, "depth_blocks": 2, "num_heads": 2, "feat": 16}
GRAD_REL, STEP_ABS, AUX_REL, TRAINED_AUX_REL = 1e-4, 1e-2, 1e-5, 1e-4


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def key_bias(grad_or_delta, dim):
    """The key third of a qkv bias (its gradient is 0 in exact arithmetic)."""
    return grad_or_delta[dim: 2 * dim]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    N, h, w = 3, 64, 64
    imgs = rng.uniform(0, 1, (N, h, w, 3)).astype(np.float32)
    yy = np.linspace(0, 1, h)[None, :, None]
    depths = (2.0 + yy + 0.3 * imgs[..., 0]).astype(np.float32)
    normals = np.stack([normals_from_depth(d, 100.0, 100.0, w / 2, h / 2) for d in depths]).astype(np.float32)
    return imgs, depths, normals


def jax_init(net_conf, hw):
    net = JMonoViT(**{**{k: v for k, v in ttm.DEFAULT_NET.items()}, **net_conf})
    return net, net.init(jax.random.PRNGKey(0), jnp.zeros((1,) + hw + (3,), jnp.float32))


def test_loss_and_gradients_equal_jax(data):
    imgs, depths, normals = data
    jnet, jp = jax_init(NET, (64, 64))
    b = jtm._make_crop_batch(np.random.default_rng(5), imgs, depths, normals, (depths > 2.2).astype(np.float32),
                             (64, 64), 2, 16, True)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(lambda p: jtm._loss_fn(jnet, p, {k: jnp.asarray(v) for k, v in b.items()}),
                                                has_aux=True))(jp)
    net = mono.MonoViT(**{**ttm.DEFAULT_NET, **NET})
    net.load_state_dict(convert.mono_state_dict(jp))
    loss, aux = ttm._loss_fn(net, {k: torch.as_tensor(v) for k, v in b.items()})
    loss.backward()
    assert abs(loss.item() - float(jl)) <= AUX_REL * abs(float(jl))
    for k in jaux:
        assert abs(float(aux[k]) - float(jaux[k])) <= AUX_REL * abs(float(jaux[k])), k
    jgrad = convert.mono_state_dict(jg)
    grads = dict(net.named_parameters())
    assert jgrad.keys() == grads.keys()
    for k, g in jgrad.items():
        t = grads[k].grad
        if k.endswith("attn.qkv.bias"):
            scale = g.abs().max()
            assert (key_bias(t, NET["dim"]) - key_bias(g, NET["dim"])).abs().max() <= GRAD_REL * scale, k
            t, g = torch.cat([t[:NET["dim"]], t[2 * NET["dim"]:]]), torch.cat([g[:NET["dim"]], g[2 * NET["dim"]:]])
        assert (t - g).abs().max() <= GRAD_REL * g.abs().max(), k
    assert all(float(grads[f"trunk.blocks_{i}.attn.qkv.weight"].grad.abs().max()) > 0 for i in range(2))


def test_schedule_is_optax_count_for_count():
    for steps, lr in ((3, 1e-3), (60, 2e-3), (500, 1e-3)):
        warmup = max(1, min(steps // 10, 50, steps - 1))
        sched = optax.warmup_cosine_decay_schedule(0.0, lr, warmup_steps=warmup, decay_steps=steps,
                                                   end_value=lr * 0.05)
        got = np.array([ttm.lr_at(c, lr, warmup, steps) for c in range(steps + 3)])
        want = np.array([float(sched(c)) for c in range(steps + 3)])
        assert got[0] == 0.0 and np.abs(got - want).max() <= 1e-6 * lr, (steps, lr)


def run_both(imgs, depths, normals, steps):
    jout = io.StringIO()
    with contextlib.redirect_stdout(jout):
        jnet, jparams, jh = jtm.train_mono(imgs, depths, normals, net_conf=NET, steps=steps, batch=2, seed=0,
                                           log_every=1)
    _, init = jax_init(NET, (64, 64))
    tout = io.StringIO()
    with contextlib.redirect_stdout(tout):
        net, params, th = ttm.train_mono(imgs, depths, normals, net_conf=NET, params=convert.mono_state_dict(init),
                                         steps=steps, batch=2, seed=0, log_every=1, device="cpu")
    return (jparams, jh, jout.getvalue()), (net, params, th, tout.getvalue()), init


def assert_trained_alike(jparams, jh, jlog, params, th, tlog, init, lr=1e-3):
    """The printed metrics of every step equal, the last step's within
    TRAINED_AUX_REL (after two updates); of the weights' changes, 99.9% of
    the elements within STEP_ABS · lr of the JAX package's and every one
    within 2 lr (Adam moves an element by about lr a step whatever its
    gradient's size, so an element whose gradient is mostly rounding, as the
    key bias's is all, moves by the sign of the rounding); the key bias by at
    most lr a step in either package."""
    assert tlog.splitlines() == jlog.splitlines() and len(tlog.splitlines()) == 3
    assert th.keys() == jh.keys() and all(abs(th[k] - jh[k]) <= TRAINED_AUX_REL * abs(jh[k]) for k in jh)
    j3, j0 = convert.mono_state_dict(jparams), convert.mono_state_dict(init)
    gaps = []
    for k, p in params.items():
        dj, dt = j3[k] - j0[k], p - j0[k]
        if k.endswith("attn.qkv.bias"):
            for d in (dj, dt):
                assert key_bias(d, NET["dim"]).abs().max() <= 2 * lr * (1 + 1e-3), k
            dj = torch.cat([dj[:NET["dim"]], dj[2 * NET["dim"]:]])
            dt = torch.cat([dt[:NET["dim"]], dt[2 * NET["dim"]:]])
        gaps.append((dt - dj).abs().flatten())
    gaps = torch.cat(gaps)
    assert (gaps <= STEP_ABS * lr).float().mean() >= 0.999 and gaps.max() <= 2 * lr


def test_three_steps_equal_jax(data, tmp_path):
    imgs, depths, normals = data
    (jparams, jh, jlog), (net, params, th, tlog), init = run_both(imgs, depths, normals, 3)
    assert_trained_alike(jparams, jh, jlog, params, th, tlog, init)
    # the port's file in the JAX package's loader: the same maps
    wpath = ttm.save_mono_params(params, tmp_path / "m.pth")
    conf = {**NET, "weights_path": str(wpath), "canonical_focal": 100.0, "resize_long": 64}
    jb, tb = JViTMonoBackend(conf), mono.ViTMonoBackend(conf, device="cpu")
    img = np.repeat(np.repeat(imgs[0], 2, 0), 2, 1)
    oj, ot = jb(img, intrinsics=(200.0, 200.0, 64.0, 64.0)), tb(img, intrinsics=(200.0, 200.0, 64.0, 64.0))
    for k in ("depth", "depth_variance", "normals", "normals_variance"):
        assert np.abs(ot[k] - oj[k]).max() <= 1e-4 * np.abs(oj[k]).max(), k


def test_fit_scene_prior_equals_jax(tmp_path, monkeypatch):
    """3 steps on a rendered 3-view RGB-D directory at resize_long 48
    (240×320 -> 36×48, a non-integer ratio), the port's trainer started
    from the JAX package's Flax init: the same metrics and weights as above,
    the same backend conf."""
    from synthetic import PlaneScene, render_scene_dir

    rng = np.random.default_rng(0)
    scene = PlaneScene(rng=rng, n_images=3, n_points=0, img_wh=(320, 240), focal=260.0, baseline=0.3)
    data = render_scene_dir(scene, tmp_path / "scene", rng=rng, depth_noise=0.01)
    kw = dict(net_conf=NET, steps=3, batch=2, resize_long=48, canonical_focal=260.0, log_every=1)
    jout = io.StringIO()
    with contextlib.redirect_stdout(jout):
        _, jconf, jh = jtm.fit_scene_prior(data, tmp_path / "j.msgpack", **kw)
    _, init = jax_init(NET, (48, 48))
    train = ttm.train_mono
    monkeypatch.setattr(ttm, "train_mono", lambda *a, **k: train(*a, params=convert.mono_state_dict(init), **k))
    tout = io.StringIO()
    with contextlib.redirect_stdout(tout):
        tpath, tconf, th = ttm.fit_scene_prior(data, tmp_path / "t.pth", device="cpu", **kw)
    from flax import serialization

    jparams = serialization.from_bytes(init, (tmp_path / "j.msgpack").read_bytes())
    params = mono.load_mono_params(tpath, mono.MonoViT(**{**ttm.DEFAULT_NET, **NET}))
    assert_trained_alike(jparams, jh, jout.getvalue(), params, th, tout.getvalue(), init)
    assert {k: v for k, v in tconf.items() if k != "weights_path"} == {k: v for k, v in jconf.items()
                                                                       if k != "weights_path"}
