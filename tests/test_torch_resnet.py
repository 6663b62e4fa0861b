"""The port's ResNet-20 (``models/resnet.py``, ``apps/resnet_app.py``)
against the JAX package's on the CPU, on JAX's own weights carried
across with ``bridge.resnet_params_from_numpy``.

What is exact and what is not:

* im2col and every MVM (each conv and projection in ``pum`` and
  ``int8``: quantisers, integer accumulator, dequant product) are bit
  for bit, on the JAX layer's own input.
* Batch-norm computes ``scale * rsqrt(var + eps)``.  XLA's CPU rsqrt is
  not correctly rounded: at var = 1 it gives 0.99999505 where torch
  gives 0.99999499, one f32 ulp apart.  So a block's output differs from
  JAX's by an ulp, and where an ulp moves a value across a rounding
  boundary of the next quantiser, one int8 code of that MVM's input
  differs.  Blocks and whole networks are held to the bounds that
  follow from that, stated at each test; ``bf16`` mode (f32 matmuls,
  summed in another order) to 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import to_numpy
from repro.apps import resnet_app as japp
from repro.config import PUMConfig as JPUM
from repro.models import resnet as jres
from repro_torch import bridge
from repro_torch.apps import resnet_app as tapp
from repro_torch.config import PUMConfig as TPUM
from repro_torch.core import pum_linear as tpl
from repro_torch.models import resnet as tres

BLOCKS = [f"s{s}b{b}" for s in range(3) for b in range(3)]
# f32 float paths: the matmuls and the mean pool sum in another order
# than XLA's, a few f32 ulps on values of O(10)
F32_TOL = dict(rtol=1e-4, atol=1e-4)


def _stride(name: str) -> int:
    return 2 if name[1] != "0" and name.endswith("b0") else 1


def _tree(width: int):
    key = jax.random.PRNGKey(0)
    jp = jres.resnet20_init(key, width=width)
    jx, _ = japp.synthetic_images(jax.random.fold_in(key, 1), 2)
    return jp, jx, bridge.resnet_params_from_numpy(to_numpy(jp), "cpu")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module", params=[8, 16], ids=["w8", "w16"])
def net(request):
    """JAX params and images, the port's params, and every block's
    input in JAX's own pum forward."""
    width = request.param
    jp, jx, tp = _tree(width)
    cfg = JPUM(mode="pum")
    h = jax.nn.relu(jres.bn_apply(jp["bn0"], jres.conv_apply(
        jp["stem"], jx, cfg), False))
    inputs = {}
    for name in BLOCKS:
        inputs[name] = h
        h = jres.block_apply(jp[name], h, cfg, _stride(name), False)
    return dict(width=width, jp=jp, jx=jx, tp=tp, inputs=inputs)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("stride", [1, 2])
def test_im2col_bit_equal(k, stride):
    x = np.random.default_rng(k + stride).normal(size=(2, 8, 8, 5)).astype(
        np.float32)
    want = np.asarray(jres.im2col(jnp.asarray(x), k, stride))
    got = tres.im2col(torch.from_numpy(x), k, stride)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_bridge_and_init_match_jax_layout(net):
    """The carried tree holds JAX's values; the port's own init draws
    the same tree of shapes, He-normal (std sqrt(2 / fan_in) within 25 %
    on the stem's and stage 2's weights), about 0.27 M weights at width
    16, as the published ResNet-20 has."""
    flat_j = jax.tree_util.tree_leaves_with_path(net["jp"])
    tp = net["tp"]
    for path, leaf in flat_j:
        node = tp
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    own = tres.resnet20_init(torch.Generator().manual_seed(0),
                             width=net["width"], device="cpu")
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), net["jp"])
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), own) == shapes
    for w in (own["stem"]["w"], own["s2b1"]["conv2"]["w"]):
        std = float(w.std())
        assert abs(std / np.sqrt(2.0 / w.shape[0]) - 1) < 0.25
    n = sum(t.numel() for t in jax.tree_util.tree_leaves(own)
            if t.ndim == 2)
    if net["width"] == 16:
        assert 0.26e6 < n < 0.28e6, n


@pytest.mark.parametrize("mode", ["pum", "int8"])
@pytest.mark.parametrize("name", BLOCKS)
def test_block_mvms_bit_equal(net, name, mode):
    """Each MVM of each block (conv1, conv2, the projection) on the JAX
    block's own input of that MVM, JAX's weights: the f32 outputs bit
    for bit (tolerance: none)."""
    jp, tp = net["jp"][name], net["tp"][name]
    jcfg, tcfg = JPUM(mode=mode), TPUM(mode=mode)
    x = net["inputs"][name]
    st = _stride(name)
    j1 = jres.conv_apply(jp["conv1"], x, jcfg, stride=st)
    np.testing.assert_array_equal(
        tres.conv_apply(tp["conv1"], _t(x), tcfg, stride=st).numpy(),
        np.asarray(j1))
    h = jax.nn.relu(jres.bn_apply(jp["bn1"], j1, False))
    np.testing.assert_array_equal(
        tres.conv_apply(tp["conv2"], _t(h), tcfg).numpy(),
        np.asarray(jres.conv_apply(jp["conv2"], h, jcfg)))
    if "proj" in jp:
        sc = x[:, ::st, ::st, :]
        np.testing.assert_array_equal(
            tpl.pum_linear(_t(sc), tp["proj"]["w"], tcfg).numpy(),
            np.asarray(jres.pum_linear(sc, jp["proj"]["w"], jcfg)))


@pytest.mark.parametrize("name", BLOCKS)
def test_block_matches_jax(net, name):
    """The whole block on the JAX block's input.  ``pum``: the one-ulp
    batch-norm difference can flip an int8 code of conv2's input; a
    code moves conv2's output by at most the row's activation scale
    (at most max|h| / 127, h the bn1 output) times the largest weight,
    and bn2 (an identity at init) passes it on: the bound is two such
    codes on an output.  ``bf16``: within 1e-4."""
    jp, tp = net["jp"][name], net["tp"][name]
    x, st = net["inputs"][name], _stride(name)
    want = jres.block_apply(jp, x, JPUM(mode="pum"), st, False)
    got = tres.block_apply(tp, _t(x), TPUM(mode="pum"), st, False)
    h = jax.nn.relu(jres.bn_apply(jp["bn1"], jres.conv_apply(
        jp["conv1"], x, JPUM(mode="pum"), stride=st), False))
    code = float(jnp.abs(h).max()) / 127 * float(
        jnp.abs(jp["conv2"]["w"]).max())
    err = np.abs(got.numpy() - np.asarray(want)).max()
    assert err <= 2 * code + 1e-5 * float(jnp.abs(want).max()), (err, code)
    want = jres.block_apply(jp, x, JPUM(mode="bf16"), st, False)
    got = tres.block_apply(tp, _t(x), TPUM(mode="bf16"), st, False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_batch_statistics_match_jax(net):
    """``train=True`` batch-norm uses the batch's mean and variance over
    N, H and W (reductions in another order: F32_TOL)."""
    x = net["inputs"]["s0b1"] * 3 + 1
    jp, tp = net["jp"]["s0b1"], net["tp"]["s0b1"]
    want = jres.bn_apply(jp["bn1"], x, True)
    got = tres.bn_apply(tp["bn1"], _t(x), True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_resnet20_bf16_logits_match_jax(net):
    want = jres.resnet20_apply(net["jp"], net["jx"], JPUM(mode="bf16"))
    got = tres.resnet20_apply(net["tp"], _t(net["jx"]), TPUM(mode="bf16"))
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("mode", ["pum", "int8"])
def test_resnet20_quantised_logits_match_jax(net, mode):
    """Through 20 layers the batch-norm ulps can flip int8 codes (see
    the module docstring), each moving its layer's output by one input
    code times a weight; the logits stay within 2 % of the largest
    logit, and every image's class is the same."""
    want = np.asarray(jres.resnet20_apply(net["jp"], net["jx"],
                                          JPUM(mode=mode)))
    got = tres.resnet20_apply(net["tp"], _t(net["jx"]),
                              TPUM(mode=mode)).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 0.02 * np.abs(want).max()
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_agreement_at_zero_noise_equals_jax():
    """The §7.5 study at sigma = 0 on JAX's own params and images
    (``resnet20_init(PRNGKey(0), width=8)``, 8 images): the same
    agreement as JAX's ``agreement_under_noise(0.0, n=8)``."""
    key = jax.random.PRNGKey(0)
    jp = jres.resnet20_init(key, width=8)
    jx, _ = japp.synthetic_images(jax.random.fold_in(key, 1), 8)
    want = japp.agreement_under_noise(0.0, n=8)
    tp = bridge.resnet_params_from_numpy(to_numpy(jp), "cpu")
    got = tapp.agreement(tp, _t(jx), 0.0)
    assert got == want
    assert got >= 0.75                # the JAX test's bound


@pytest.fixture
def one_thread():
    """Run a test on one intra-op thread, then restore the count.  The
    analog-noise path issues thousands of tiny ops a forward (one ADC
    quantisation a bit line and slice), whose thread-pool barriers stall
    when several test workers share the cores: 1.6 s alone at one
    thread, 7.5 s at eight, minutes under a six-worker run.  The
    numbers are the same either way (each checked bit for bit against
    itself)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.usefixtures("one_thread")
def test_noise_follows_the_generator():
    """Programming noise drawn from the generator: the same seed gives
    the same logits bit for bit, another seed others, and noise on
    differs from noise off."""
    gen = torch.Generator().manual_seed(3)
    tp = tres.resnet20_init(gen, width=8, device="cpu")
    x, _ = tapp.synthetic_images(gen, 2, device="cpu")

    def run(seed, sigma=0.05):
        return tres.resnet20_apply(
            tp, x, tapp.pum_config(sigma),
            generator=torch.Generator().manual_seed(seed))

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, run(0, 0.0))
    assert torch.isfinite(a).all()


@pytest.mark.usefixtures("one_thread")
def test_agreement_under_noise_on_the_cpu():
    """The entry point draws params, images and noise from one seeded
    generator: the same seed gives the same agreement."""
    clean = tapp.agreement_under_noise(0.0, n=4, width=8, device="cpu")
    noisy = tapp.agreement_under_noise(0.3, n=4, width=8, device="cpu")
    assert 0.0 <= noisy <= 1.0 and 0.0 <= clean <= 1.0
    assert noisy == tapp.agreement_under_noise(0.3, n=4, width=8,
                                               device="cpu")


def test_synthetic_images_law():
    """Class prototypes N(0, 0.5^2) plus N(0, 0.3^2) per image: images
    of one class lie 0.3 apart per pixel, the pixels' std is
    sqrt(0.25 + 0.09) = 0.583 (within 10 % over 64 images)."""
    x, y = tapp.synthetic_images(torch.Generator().manual_seed(0), 64,
                                 device="cpu")
    assert x.shape == (64, 32, 32, 3) and x.dtype == torch.float32
    assert y.shape == (64,) and 0 <= int(y.min()) and int(y.max()) < 10
    assert abs(float(x.std()) / np.sqrt(0.34) - 1) < 0.1
    same = (y[:, None] == y[None]).nonzero()
    i, j = next((int(a), int(b)) for a, b in same if a != b)
    assert abs(float((x[i] - x[j]).std()) / np.sqrt(0.18) - 1) < 0.1


def test_entry_points_refuse_the_cpu_unasked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = torch.Generator()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tres.resnet20_init(gen)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tapp.synthetic_images(gen, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tapp.agreement_under_noise(0.0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bridge.resnet_params_from_numpy({"w": np.zeros(2)})
