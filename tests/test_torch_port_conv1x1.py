"""K5, the 1x1 convolution kernel (``ops/conv1x1.py``), on the CPU: its
plain version against the unfolded ``Conv2d`` -> eval ``BatchNorm2d`` ->
(residual) -> (ReLU) at every 1x1 shape of ResNet-50 at 128 px with random
batch-norm statistics, an emulation of its 3xTF32 products, its launch
rule, the Bottleneck's pack cache, ``block_packs``, the ``k5_convs`` count,
the route's rule (no kernel where autograd wants a gradient), and the
training and CPU paths left as they were.

The tests marked ``card`` run on a CUDA card (``PLAYAID_TEST_TPU=1 python -m
pytest tests/test_torch_port_conv1x1.py -m card``) and skip elsewhere: the
kernel against its plain version at every shape.
"""

import copy
from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from playaid_core_torch import profiling
from playaid_core_torch.models.resnet import (
    BatchNorm2d,
    Bottleneck,
    block_packs,
    fold_batch_norm,
    make_resnet,
)
from playaid_core_torch.ops.conv1x1 import (
    SLICE_CHANNELS,
    SPLITS,
    TILES,
    conv1x1_packed,
    conv1x1_ref,
    launch_shape,
    launch_smem,
    pack_conv1x1,
)
from playaid_core_torch.ops.conv_block import SMEM_PER_SM, tf32_round
from portbench import k5, roofline
from portbench.catalog import Catalog

torch.set_num_threads(2)

RESNET50_CONVS = k5.k5_convs(Catalog().family("resformer"), 128)


def _resnet50_convs():
    """``(c_in, c_out, stride, side in)`` of the 1x1 convolutions the port
    runs on K5 in ResNet-50 at 128 px (``portbench/k5.py``), each shape
    once: every block's conv1 and conv3 and the projections."""
    shapes = []
    for conv in RESNET50_CONVS:
        if conv[:4] not in shapes:
            shapes.append(conv[:4])
    return shapes


SHAPES = _resnet50_convs()
EPILOGUES = ("relu", "residual", "none")  # conv1, conv3, the projection


def _shape_id(shape):
    return "{}to{}s{}x{}".format(*shape)


def _conv_bn(c_in, c_out, stride, seed):
    """A 1x1 conv and an eval batch norm with random weights, scales,
    biases, running means and variances."""
    g = torch.Generator().manual_seed(seed)
    conv = nn.Conv2d(c_in, c_out, 1, stride, bias=False)
    bn = BatchNorm2d(c_out)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=g) * (2 / c_in) ** 0.5)
        bn.weight.copy_(torch.rand(c_out, generator=g) + 0.5)
        bn.bias.copy_(torch.randn(c_out, generator=g) * 0.1)
        bn.running_mean.copy_(torch.randn(c_out, generator=g) * 0.2)
        bn.running_var.copy_(torch.rand(c_out, generator=g) + 0.5)
    return conv, bn.eval()


def _inputs(shape, epilogue, batch=2, seed=0):
    c_in, c_out, stride, side = shape
    g = torch.Generator().manual_seed(seed + 1)
    x = torch.relu(torch.randn((batch, c_in, side, side), generator=g))
    s_out = (side - 1) // stride + 1
    res = (torch.randn((batch, c_out, s_out, s_out), generator=g)
           if epilogue == "residual" else None)
    return x, res


def test_the_shapes_are_resnet50s_36_convolutions():
    blocks = list(roofline._blocks("resnet50", 128))
    projections = sum(stride != 1 or i != o for i, _, o, stride, _, _ in blocks)
    assert 2 * len(blocks) + projections == len(RESNET50_CONVS) == 36 and len(SHAPES) == 15


@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
def test_plain_version_folds_batch_norm(shape, epilogue):
    """The pack's folded scale and bias, through the plain version, give
    the unfolded conv -> eval batch norm -> (+ residual) -> (ReLU)."""
    c_in, c_out, stride, _ = shape
    conv, bn = _conv_bn(c_in, c_out, stride, seed=c_in + c_out + stride)
    x, res = _inputs(shape, epilogue)
    relu = epilogue != "none"
    with torch.no_grad():
        want = bn(conv(x))
        if res is not None:
            want = want + res
        want = torch.relu(want) if relu else want
        got = conv1x1_packed(x, pack_conv1x1(conv.weight, *fold_batch_norm(bn)), stride, res,
                             relu)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def _split(t):
    hi = tf32_round(t)
    return hi, tf32_round(t - hi)


@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
def test_3xtf32_emulation_holds_the_f32_gate(shape):
    """The kernel's three TF32 products on the packed halves (a_lo*b_hi +
    a_hi*b_lo + a_hi*b_hi) hold the 1e-4 * max|ref| gate against the
    product in float64 at every shape, up to a depth of 2,048; one TF32
    pass does not."""
    c_in, c_out, stride, _ = shape
    conv, bn = _conv_bn(c_in, c_out, stride, seed=7)
    x, _ = _inputs(shape, "none", seed=7)
    w_hi, w_lo = pack_conv1x1(conv.weight, *fold_batch_norm(bn)).w
    w_hi, w_lo = (w[:, :, None, None] for w in (w_hi, w_lo))
    x_hi, x_lo = _split(x)
    with torch.no_grad():
        ref = F.conv2d(x.double(), conv.weight.double(), stride=stride)
        three = (F.conv2d(x_lo, w_hi, stride=stride) + F.conv2d(x_hi, w_lo, stride=stride)
                 + F.conv2d(x_hi, w_hi, stride=stride))
        one = F.conv2d(x_hi, w_hi, stride=stride)
    gate = 1e-4 * float(ref.abs().max())
    assert float((three - ref).abs().max()) <= gate < float((one - ref).abs().max())


def test_pack_splits_tf32_halves():
    conv, bn = _conv_bn(64, 256, 1, seed=3)
    pack = pack_conv1x1(conv.weight, *fold_batch_norm(bn))
    assert tuple(pack.w.shape) == (2, 256, 64) and pack.w.is_contiguous()
    hi, lo = pack.w
    low_13_bits = 0x1FFF
    assert not (hi.view(torch.int32) & low_13_bits).any()
    assert not (lo.view(torch.int32) & low_13_bits).any()
    w = conv.weight.detach().reshape(256, 64)
    assert bool(((hi + lo - w).abs() <= 2.0 ** -21 * w.abs()).all())
    s, b = fold_batch_norm(bn)
    assert torch.equal(pack.scale, s.detach()) and torch.equal(pack.bias, b.detach())
    with pytest.raises(ValueError):
        pack_conv1x1(torch.zeros(256, 64, 3, 3), s, b)


@pytest.mark.parametrize("batch", [48, 24, 7])
@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
def test_launch_shape_fits(shape, batch):
    """At each shape at a VOD chunk, a mesh replica's half of one and a
    dashboard sample: the tile divides the channels, its shared memory
    fits an SM, and a split leaves each block two depth slices or more."""
    c_in, c_out, stride, side = shape
    s_out = (side - 1) // stride + 1
    bm, bn, split = launch_shape(batch * s_out * s_out, c_out, c_in)
    assert (bm, bn) in TILES and split in SPLITS
    assert c_out % bn == 0 and launch_smem(bm, bn) <= SMEM_PER_SM
    assert split == 1 or (c_in // SLICE_CHANNELS) // split >= 2


def test_launch_shape_picks():
    """The picks at a VOD chunk's shapes, the fastest or near it on the card:
    64 x 64 tiles where the output has 64 channels, 128 x 128 where those
    tiles fill the card, and 64 x 128 split in two over layer 4's depth of
    2,048 at 768 rows, where 128 x 128 tiles would be 96 for 132 SMs."""
    assert launch_shape(48 * 1024, 64, 64) == (64, 64, 1)
    assert launch_shape(48 * 1024, 256, 64) == (128, 128, 1)
    assert launch_shape(48 * 256, 512, 128) == (128, 128, 1)
    assert launch_shape(48 * 64, 1024, 256) == (64, 128, 1)
    assert launch_shape(48 * 16, 512, 2048) == (64, 128, 2)


def test_launch_shape_refuses_what_the_kernel_does_not_take():
    for m, n, k in ((768, 96, 512), (768, 512, 48), (0, 512, 512)):
        with pytest.raises(ValueError):
            launch_shape(m, n, k)


def test_packed_conv_on_cpu_runs_the_plain_version():
    conv, bn = _conv_bn(128, 256, 2, seed=5)
    pack = pack_conv1x1(conv.weight, *fold_batch_norm(bn))
    x, res = _inputs((128, 256, 2, 9), "residual")
    before = conv1x1_packed.launches
    out = conv1x1_packed(x, pack, 2, res)
    want = conv1x1_ref(x, pack.w.sum(0), pack.scale, pack.bias, 2, res)
    assert tuple(out.shape) == (2, 256, 5, 5) and torch.equal(out, want)
    assert conv1x1_packed.launches == before
    with pytest.raises(TypeError):
        conv1x1_packed(x.double(), pack, 2, res)
    with pytest.raises(ValueError):
        conv1x1_packed(x, pack, 1, res)  # the residual is [2, 256, 5, 5], the output 9 x 9
    with pytest.raises(ValueError):
        conv1x1_packed(x[:, :64], pack, 2)


def _random_stats(module, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.weight.copy_(torch.rand(m.num_features, generator=g) + 0.5)
                m.bias.copy_(torch.randn(m.num_features, generator=g) * 0.1)
                m.running_mean.copy_(torch.randn(m.num_features, generator=g) * 0.2)
                m.running_var.copy_(torch.rand(m.num_features, generator=g) + 0.5)
    return module


def _bottleneck(projection, seed=0):
    torch.manual_seed(seed)
    block = Bottleneck(256, 128, stride=2) if projection else Bottleneck(256, 64)
    return _random_stats(block, seed).eval()


def _assert_pack_matches(block, pack):
    convs = [(block.conv1, block.bn1, pack.conv1), (block.conv3, block.bn3, pack.conv3)]
    if block.downsample is not None:
        convs.append((*block.downsample, pack.downsample))
    else:
        assert pack.downsample is None
    for conv, bn, p in convs:
        w = conv.weight.detach().reshape(p.w.shape[1:])
        assert bool(((p.w.sum(0) - w).abs() <= 2.0 ** -21 * w.abs()).all())
        s, b = fold_batch_norm(bn)
        assert torch.equal(p.scale, s.detach()) and torch.equal(p.bias, b.detach())


@pytest.mark.parametrize("projection", [False, True])
def test_bottleneck_pack_cache_never_serves_stale_weights(projection):
    block = _bottleneck(projection)
    first = block.block_pack()
    assert block.block_pack() is first  # kept while nothing changed
    _assert_pack_matches(block, first)

    block.load_state_dict(_bottleneck(projection, seed=1).state_dict())
    reloaded = block.block_pack()
    assert reloaded is not first
    _assert_pack_matches(block, reloaded)

    with torch.no_grad():
        (block.downsample[1] if projection else block.bn3).running_var.mul_(2.0)
    edited = block.block_pack()
    assert edited is not reloaded
    _assert_pack_matches(block, edited)

    block.train()
    assert block._pack is None
    block(torch.rand(2, 256, 8, 8))  # a training step moves the running statistics
    block.eval()
    after_training = block.block_pack()
    assert after_training is not edited
    _assert_pack_matches(block, after_training)


def test_block_packs_holds_the_bottlenecks_packs():
    """What a captured graph reads: each block's pack while it holds one,
    none once ``train()`` dropped them."""
    net = make_resnet("resnet50", num_classes=0).eval()
    blocks = [m for m in net.modules() if isinstance(m, Bottleneck)]
    assert len(blocks) == 16 and block_packs(net) == []
    packs = [b.block_pack() for b in blocks[:3]]
    held = block_packs(net)
    assert [b for b, _ in held] == blocks[:3]
    assert all(p[1] is pack for (_, p), pack in zip(held, packs))
    net.train()
    assert block_packs(net) == []


def _forward_before_k5(block, x):
    """``Bottleneck.forward`` as it was before K5: the path training and the
    CPU keep."""
    y = torch.relu(block.bn1(block.conv1(x)))
    y = torch.relu(block.bn2(block.conv2(y)))
    y = block.bn3(block.conv3(y))
    residual = x if block.downsample is None else block.downsample(x)
    return torch.relu(residual + y)


ROUTES = [
    # (grad mode, parameters require grad, x requires grad, training, cuda, dtype) -> fused
    ("no_grad", True, True, False, True, torch.float32, True),
    ("inference_mode", True, False, False, True, torch.float32, True),
    ("enabled", False, False, False, True, torch.float32, True),
    ("enabled", True, False, False, True, torch.float32, False),
    ("enabled", False, True, False, True, torch.float32, False),
    ("no_grad", True, False, True, True, torch.float32, False),
    ("no_grad", True, False, False, False, torch.float32, False),
    ("no_grad", True, False, False, True, torch.float16, False),
]


@pytest.mark.parametrize("grad,params,x_grad,training,cuda,dtype,fused", ROUTES)
def test_route_follows_grad_mode(grad, params, x_grad, training, cuda, dtype, fused):
    """The block takes the kernel, which has no backward, only where no
    gradient is wanted through it: in eval mode on a CUDA float32 map with
    grad mode off, or with neither the map nor a parameter requiring one
    (a frozen trunk).  Fine-tuning or a saliency map in eval mode keeps the
    unfused path and its gradient."""
    block = _bottleneck(projection=True).train(training)
    block.requires_grad_(params)
    x = SimpleNamespace(is_cuda=cuda, dtype=dtype, requires_grad=x_grad)
    mode = {"no_grad": torch.no_grad, "inference_mode": torch.inference_mode,
            "enabled": torch.enable_grad}[grad]
    with mode():
        assert block.runs_fused(x) is fused


def _backward_reaches_the_weights(device):
    block = _bottleneck(projection=True, seed=8).to(device)
    x = torch.rand(2, 256, 8, 8, generator=torch.Generator().manual_seed(9)).to(device)
    x.requires_grad_(True)
    launches = conv1x1_packed.launches
    block(x).sum().backward()
    grads = [block.conv1.weight.grad, block.conv3.weight.grad, block.downsample[0].weight.grad,
             x.grad]
    assert all(g is not None and bool(g.abs().sum() > 0) for g in grads)
    assert conv1x1_packed.launches == launches and block._pack is None


def test_eval_mode_backward_reaches_the_weights():
    """A backward pass through an eval-mode block reaches its 1x1 weights
    and its input; the card's variant below shows that the kernel stays
    out of it there."""
    _backward_reaches_the_weights(torch.device("cpu"))


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("projection", [False, True])
def test_training_and_cpu_paths_unchanged(projection, training):
    """On the CPU, in eval and in training mode, the block computes what it
    computed before K5, bit for bit, running statistics included."""
    block = _bottleneck(projection, seed=2).train(training)
    before = copy.deepcopy(block)
    x = torch.rand(2, 256, 8, 8, generator=torch.Generator().manual_seed(4))
    launches = conv1x1_packed.launches
    with torch.no_grad():
        got, want = block(x), _forward_before_k5(before, x)
    assert torch.equal(got, want) and conv1x1_packed.launches == launches
    for (name, a), (_, b) in zip(block.state_dict().items(), before.state_dict().items()):
        assert torch.equal(a, b), name
    assert block._pack is None


@pytest.mark.parametrize("projection", [False, True])
def test_fused_block_counts_into_its_span(projection):
    """The fused route on a CPU tensor (the plain version under each 1x1)
    gives the block's output and adds its 1x1 convolutions, 2 or 3, to the
    enclosing span's ``k5_convs``."""
    block = _bottleneck(projection, seed=3)
    x = torch.rand(2, 256, 8, 8, generator=torch.Generator().manual_seed(5))
    with profiling.recording() as rec:
        with profiling.span("playaid.embed", crops=2):
            with torch.no_grad():
                out = block._fused_forward(x)
    assert rec.summary()["playaid.embed"]["k5_convs"] == (3 if projection else 2)
    with torch.no_grad():
        want = block(x)
    assert float((out - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("arch,convs", [("resnet50", 36), ("resnet18", 0)])
def test_a_fused_embed_counts_every_1x1(monkeypatch, arch, convs):
    """With every Bottleneck on its fused route, one call of ResNet-50
    counts 36 ``k5_convs`` and gives the unfused features; ResNet-18 has no
    Bottleneck and counts none."""
    torch.manual_seed(6)
    net = _random_stats(make_resnet(arch, num_classes=0), 6).eval()
    x = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        want = net(x)
    monkeypatch.setattr(Bottleneck, "forward", Bottleneck._fused_forward)
    with profiling.recording() as rec, torch.no_grad():
        with profiling.span("playaid.embed", crops=2):
            got = net(x)
    assert rec.summary()["playaid.embed"].get("k5_convs", 0) == convs
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


# ---- on the card ----


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
def test_card_kernel_against_plain_version(card, shape):
    """K5 at a VOD chunk of 48 crops against its plain version on the card,
    each epilogue."""
    from playaid_core_torch.device import full_float32

    c_in, c_out, stride, _ = shape
    conv, bn = _conv_bn(c_in, c_out, stride, seed=11)
    pack = pack_conv1x1(conv.weight.to(card), *(t.to(card) for t in fold_batch_norm(bn)))
    for epilogue in EPILOGUES:
        x, res = (t if t is None else t.to(card) for t in _inputs(shape, epilogue, batch=48))
        relu = epilogue != "none"
        with full_float32():
            want = conv1x1_ref(x, conv.weight.to(card), pack.scale, pack.bias, stride, res,
                               relu)
        got = conv1x1_packed(x, pack, stride, res, relu)
        assert got.is_contiguous()
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.card
def test_card_eval_mode_backward_reaches_the_weights(card):
    """On the card, with grad mode on, an eval-mode block runs unfused and
    the backward pass reaches its 1x1 weights."""
    _backward_reaches_the_weights(card)
