"""The port's IISPTNet training against the JAX package's, at test size
(K = 8, 8^2 hemispheres, batch 4): the flax-style initialization, the
train step, the checkpoint formats both ways, the evaluation statistics
and the two CLIs.

Both sides start from flax's initialization of the JAX ``IISPTNet``,
carried across.  Tolerances:
  - the init: each kernel's standard deviation within 10% of
    1/sqrt(fan_in), no draw beyond 2 standard deviations of the
    untruncated normal, zero biases;
  - the train step, 3 Adam steps at lr 1e-3 against
    ``parallel/sharded.py::make_train_step`` on a 1-device mesh: in
    float64 on both sides, the losses within 1e-5 relative, and every
    parameter and BatchNorm running mean and variance within 1e-5 of its
    tensor's max |value|; the port's float32 losses within 1e-5 relative
    of the same reference.
    The parameters are compared in float64 because in float32 Adam
    turns rounding noise into whole steps: a convolution bias feeding
    BatchNorm gets a gradient that nearly cancels (~1e-6 of the tensor's
    largest; the two libraries' float32 gradients differ by ~5e-6 of
    each tensor's largest, as much as JAX's jitted and eager gradients
    differ from each other), and Adam's normalized update moves it by
    +-lr whatever its size;
  - round trips: the port's npz read by the JAX ``load_pretrained``
    gives the port's outputs within 1e-5 max|y| (float16 weights on
    both sides); a JAX checkpoint pickle, read by the port with jax
    blocked, gives the same tensors; ``save_state`` / ``load_state``
    resume bit for bit;
  - ``compare_predictions``: means within 1e-5 relative, p-values within
    1e-6 relative.
"""

import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pbrt_v3_iile_tpu.ml import evalstats as jeval
from pbrt_v3_iile_tpu.ml import train as jtrain
from pbrt_v3_iile_tpu.models import iisptnet as jnet
from pbrt_v3_iile_tpu.parallel import mesh as meshlib
from pbrt_v3_iile_tpu.parallel import sharded
from pbrt_v3_iile_tpu_torch.ml import evalstats as teval
from pbrt_v3_iile_tpu_torch.ml import train as ttrain
from pbrt_v3_iile_tpu_torch.models import iisptnet as tnet
from pbrt_v3_iile_tpu_torch.models import weights as tweights
from pbrt_v3_iile_tpu_torch.utils import image as timage

from torch_parity import REPO

HEMI, K, B = 8, 8, 4
GOLDEN_BOX = os.path.join(REPO, "tests", "golden", "train_box32_bvh_h8_g4_s2_s0.npz")


@pytest.fixture(scope="module")
def flax_init():
    """The JAX net of width K and flax's initialization of it (numpy)."""
    net = jnet.IISPTNet(k=K)
    init = jax.jit(lambda key: net.init(key, jnp.zeros((1, HEMI, HEMI, 7)),
                                        train=False))
    return net, jax.tree.map(np.asarray, init(jax.random.PRNGKey(2)))


def small_state(seed):
    """init_training's state for a net of width K."""
    net = tnet.init_params(tnet.IISPTNet(k=K), torch.Generator().manual_seed(seed))
    opt = torch.optim.Adam(net.parameters(), lr=ttrain.LEARNING_RATE)
    return dict(net=net, optimizer=opt, step=ttrain.make_train_step(net, opt))


def batches(dtype, n=3):
    rng = np.random.default_rng(0)
    return [(rng.normal(size=(B, HEMI, HEMI, 7)).astype(dtype),
             np.abs(rng.normal(size=(B, HEMI, HEMI, 3))).astype(dtype))
            for _ in range(n)]


def rel_to_max(got, want):
    """{path: max |got - want| / max |want|} over flax-style trees."""
    out = {}
    for top in want:
        for mod in want[top]:
            for name, b in want[top][mod].items():
                a = got[top][mod][name]
                assert a.shape == b.shape, (top, mod, name)
                out[f"{top}/{mod}/{name}"] = float(
                    np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
    return out


def test_init_matches_flax_distribution():
    state = ttrain.init_training(torch.Generator().manual_seed(0), HEMI, device="cpu")
    net = state["net"]
    assert net.k == tnet.K
    assert state["optimizer"].defaults["lr"] == ttrain.LEARNING_RATE == 6e-5
    for conv in (*net.conv, *net.convt):
        w = conv.weight.detach().numpy()
        fan_in = w.shape[1] * w.shape[2] * w.shape[3]
        target = 1.0 / np.sqrt(fan_in)
        assert abs(w.std() / target - 1.0) < 0.1, (w.shape, w.std(), target)
        # truncated at 2 standard deviations of the untruncated normal
        assert np.abs(w).max() <= 2.0 * target / 0.87962566103423978 + 1e-7
        assert not conv.bias.detach().any()
    for bn in net.bn:
        assert torch.equal(bn.weight, torch.ones_like(bn.weight))
        assert not bn.bias.detach().any() and not bn.running_mean.any()
        assert torch.equal(bn.running_var, torch.ones_like(bn.running_var))
    again = tnet.init_params(tnet.IISPTNet(), torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(net.state_dict().values(),
                                                  again.state_dict().values()))


def jax_steps(net, variables, data, dtype):
    """3 steps of the JAX package's train step (1-device mesh, Adam 1e-3)."""
    opt = optax.adam(1e-3)
    step = sharded.make_train_step(net, opt, meshlib.make_mesh(1))
    cast = lambda t: jax.tree.map(lambda a: jnp.asarray(a, dtype), t)
    params, stats = cast(variables["params"]), cast(variables["batch_stats"])
    opt_state = opt.init(params)
    losses = []
    for x, y in data:
        params, stats, opt_state, loss = step(params, stats, opt_state,
                                              jnp.asarray(x), jnp.asarray(y))
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, {"params": params,
                                             "batch_stats": stats})


def port_steps(variables, data, dtype):
    net = tweights.iisptnet_from_flax(variables).to(dtype)
    step = ttrain.make_train_step(net, torch.optim.Adam(net.parameters(), lr=1e-3))
    losses = [float(step(torch.from_numpy(x), torch.from_numpy(y)))
              for x, y in data]
    sd = {k: v.to(torch.float64) for k, v in net.state_dict().items()}
    return losses, tweights.flax_from_state_dict(sd), net


def test_train_step_matches_jax(flax_init):
    net, variables = flax_init
    data = batches(np.float64)
    with jax.enable_x64(True):
        jl, want = jax_steps(net, variables, data, jnp.float64)
    tl, got, _ = port_steps(variables, data, torch.float64)
    for a, b in zip(tl, jl):
        assert abs(a - b) <= 1e-5 * abs(b), (tl, jl)
    errs = rel_to_max(got, want)
    assert max(errs.values()) <= 1e-5, sorted(errs.items(), key=lambda kv: -kv[1])[:5]
    # the running variance moved (torch's unbiased update would be off by
    # n/(n-1) = 4/3 in the 1x1 bottleneck's BatchNorm)
    assert not np.allclose(want["batch_stats"]["BatchNorm_2"]["var"], 1.0)
    # the port's float32 step, as it trains: its losses against the same
    # reference
    tl32, _, tn = port_steps(variables, [(x.astype(np.float32), y.astype(np.float32))
                                         for x, y in data], torch.float32)
    for a, b in zip(tl32, jl):
        assert abs(a - b) <= 1e-5 * abs(b), (tl32, jl)
    assert all(np.isfinite(p.detach().numpy()).all() for p in tn.parameters())


def test_save_pretrained_read_by_jax(flax_init, tmp_path):
    net, variables = flax_init
    state = small_state(1)
    x, y = batches(np.float32, 1)[0]
    state["step"](torch.from_numpy(x), torch.from_numpy(y))   # non-trivial stats
    path = str(tmp_path / "trained.npz")
    ttrain.save_pretrained(path, state)
    jvars = jtrain.load_pretrained(path)
    want = np.asarray(jax.jit(lambda v, x: net.apply(v, x, train=False))(
        jvars, jnp.asarray(x)))
    port = tweights.load_iisptnet(path, device="cpu")
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), \
        np.abs(got - want).max()
    # the port's own npz reader, the JAX reader and load_pretrained agree
    mine = ttrain.load_pretrained(path)
    assert max(rel_to_max(mine, jax.tree.map(np.asarray, jvars)).values()) == 0.0


BLOCKED_LOAD = r"""
import sys
sys.modules["jax"] = None
sys.modules["pbrt_v3_iile_tpu"] = None
import torch
from pbrt_v3_iile_tpu_torch.ml import train
from pbrt_v3_iile_tpu_torch.models import weights
net = weights.iisptnet_from_flax(train.load_checkpoint(sys.argv[1]))
torch.save(net.state_dict(), sys.argv[2])
"""


def test_jax_checkpoint_read_by_port_without_jax(flax_init, tmp_path):
    _, variables = flax_init
    ckpt = str(tmp_path / "model.ckpt")
    jtrain.save_checkpoint(ckpt, variables)
    out = str(tmp_path / "sd.pt")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get(
        "PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-c", BLOCKED_LOAD, ckpt, out],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    got = torch.load(out, weights_only=True)
    want = tweights.state_dict_from_flax(variables)
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_port_checkpoint_read_by_jax(tmp_path):
    state = small_state(3)
    ckpt = str(tmp_path / "model.ckpt")
    ttrain.save_checkpoint(ckpt, state)
    blob = jtrain.load_checkpoint(ckpt)
    want = ttrain.inference_variables(state)
    assert max(rel_to_max(jax.tree.map(np.asarray, blob), want).values()) == 0.0
    mine = ttrain.load_checkpoint(ckpt)
    assert max(rel_to_max(mine, want).values()) == 0.0


def test_save_state_resumes_bit_for_bit(tmp_path):
    data = [(torch.from_numpy(x), torch.from_numpy(y))
            for x, y in batches(np.float32, 4)]
    new = lambda: small_state(4)
    a = new()
    for x, y in data[:2]:
        a["step"](x, y)
    path = str(tmp_path / "state.pt")
    ttrain.save_state(path, a, step=2)
    la = [float(a["step"](x, y)) for x, y in data[2:]]
    b, step = ttrain.load_state(path, new())
    assert step == 2
    lb = [float(b["step"](x, y)) for x, y in data[2:]]
    assert la == lb
    sa, sb = a["net"].state_dict(), b["net"].state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)


def test_compare_predictions_matches_jax(flax_init):
    net, variables = flax_init
    g = np.load(GOLDEN_BOX)
    raw = {k: g[k] for k in ("p", "d", "n", "z", "valid")}

    class Jitted:                       # the JAX net with a compiled apply
        apply = staticmethod(jax.jit(net.apply, static_argnames="train"))

    want = jeval.compare_predictions(raw, Jitted, variables)
    got = teval.compare_predictions(raw, tweights.iisptnet_from_flax(variables))
    for metric in ("l1", "ssim"):
        for k, v in want["means"][metric].items():
            assert abs(got["means"][metric][k] - v) <= 1e-5 * abs(v), (metric, k)
    assert got["p_values"].keys() == want["p_values"].keys()
    for k, v in want["p_values"].items():
        assert abs(got["p_values"][k] - v) <= 1e-6 * abs(v), (k, got["p_values"][k], v)
    assert teval.report(got).splitlines()[1:3] == jeval.report(want).splitlines()[1:3]


SCENE16 = """
LookAt 0 2.5 -6  0 2.5 0  0 1 0
Camera "perspective" "float fov" [60]
Film "image" "integer xresolution" [16] "integer yresolution" [16]
Sampler "sobol" "integer pixelsamples" [1]
Integrator "iispt" "integer maxdepth" [4]
WorldBegin
AttributeBegin
  Material "matte" "color Kd" [0 0 0]
  AreaLightSource "area" "color L" [20 20 20]
  Translate 0 4.5 0
  Shape "sphere" "float radius" [0.4]
AttributeEnd
Material "matte" "color Kd" [0.6 0.6 0.6]
Shape "trianglemesh" "point P" [-5 0 -5 5 0 -5 5 0 5 -5 0 5]
  "integer indices" [0 1 2 2 3 0]
Material "matte" "color Kd" [0.7 0.3 0.3]
Shape "trianglemesh" "point P" [-5 0 3 5 0 3 5 5 3 -5 5 3]
  "integer indices" [0 1 2 2 3 0]
WorldEnd
"""


def _render_iispt(scene, out, *extra):
    from pbrt_v3_iile_tpu_torch.cli import main as tcli

    assert tcli.main([str(scene), str(out), "--integrator", "iispt",
                      "--iileIndirect", "1", "--iileDirect", "1",
                      "--iispt_hemi_size", str(HEMI), "--device", "cpu",
                      *extra]) == 0
    img = timage.read_pfm(str(out))
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    return img


def test_cli_train_then_render_with_checkpoint(tmp_path, capsys):
    """cli.train on the CPU end to end (dataset, training, the npz), then
    cli.main renders IILE with the trained net."""
    from pbrt_v3_iile_tpu_torch.cli import train as tcli_train

    scene = tmp_path / "room.pbrt"
    scene.write_text(SCENE16)
    work = tmp_path / "work"
    assert tcli_train.main(["--scene", str(scene), "--grid", "4", "--reps", "1",
                            "--gt-spp", "2", "--hemi", str(HEMI), "--steps", "2",
                            "--workdir", str(work), "--device", "cpu"]) == 0
    npz = work / "iispt_trained.npz"
    assert (work / "ds_room.npz").exists() and (work / "train_state.pt").exists()
    assert "steps 2:" in capsys.readouterr().out
    trained = tweights.load_iisptnet(str(npz), device="cpu")
    assert trained.k == tnet.K
    pretrained = tweights.load_iisptnet(device="cpu")
    assert not torch.equal(trained.conv[0].weight, pretrained.conv[0].weight)
    img = _render_iispt(scene, tmp_path / "trained.pfm", "--checkpoint", str(npz))
    assert img.mean() > 0
    # a second run resumes the dataset and the state, and trains no step
    assert tcli_train.main(["--scene", str(scene), "--grid", "4", "--reps", "1",
                            "--gt-spp", "2", "--hemi", str(HEMI), "--steps", "2",
                            "--workdir", str(work), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[room] resumed" in out
    assert "resumed the training state at step 2" in out and "steps 2:" not in out


def test_cli_checkpoint_pickle_and_iile_control(tmp_path, capsys):
    """--checkpoint with a training pickle, and --iileControl's three
    preview images."""
    scene = tmp_path / "room.pbrt"
    scene.write_text(SCENE16)
    ckpt = tmp_path / "model.ckpt"
    with open(ckpt, "wb") as f:
        pickle.dump(ttrain.load_pretrained(ttrain.default_pretrained_path()), f)
    control = tmp_path / "control"
    img = _render_iispt(scene, tmp_path / "out.pfm", "--checkpoint", str(ckpt),
                        "--iileControl", str(control))
    lines = capsys.readouterr().out.splitlines()
    assert lines.index("#REFRESH!") < lines.index("#FINISH!")
    direct = timage.read_pfm(str(control / "out_direct.pfm"))
    indirect = timage.read_pfm(str(control / "out_indirect.pfm"))
    combined = timage.read_pfm(str(control / "out_combined.pfm"))
    assert direct.shape == indirect.shape == combined.shape == (16, 16, 3)
    assert np.array_equal(combined, img)
    assert np.allclose(direct + indirect, combined, rtol=1e-6, atol=1e-7)
    assert indirect.mean() > 0


def test_load_iisptnet_on_the_cpu():
    net = tweights.load_iisptnet(device="cpu")
    assert not net.training
    assert all(p.device.type == "cpu" for p in net.parameters())
    import inspect
    assert inspect.signature(tweights.load_iisptnet).parameters["device"].default == "cuda"
