"""The arithmetic and bookkeeping around the port's hand-written kernels,
on the CPU: the residual block's weight pack, an emulation of its 3xTF32
products, the model's pack cache, and the float32 numerics of the entry
points.  The kernels themselves run only on the card (chip_smoke.py).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from playaid_core_tpu.ops.pallas_conv_block import xla_residual_block
from playaid_core_torch import profiling
from playaid_core_torch.infer.pipeline import BatchedActionPipeline
from playaid_core_torch.models.resnet import BasicBlock, Bottleneck, fold_batch_norm, make_resnet
from playaid_core_torch.ops.conv_block import (
    SMEM_PER_SM,
    SMS,
    TILES,
    launch_shape,
    launch_smem,
    pack_block,
    residual_block_packed,
    residual_block_ref,
    tf32_round,
    unpack_weight,
)

torch.set_num_threads(2)

LOW_13_BITS = 0x1FFF


def _block_inputs(b, c, seed=0, hw=(4, 4)):
    rng = np.random.default_rng(seed)
    x = np.maximum(rng.normal(0, 1, (b, *hw, c)), 0).astype(np.float32)
    w1, w2 = (rng.normal(0, (2 / (9 * c)) ** 0.5, (3, 3, c, c)).astype(np.float32)
              for _ in range(2))
    s1, s2 = (rng.uniform(0.5, 1.5, c).astype(np.float32) for _ in range(2))
    b1, b2 = (rng.normal(0, 0.1, c).astype(np.float32) for _ in range(2))
    return x, w1, s1, b1, w2, s2, b2


def _low_bits(t):
    return t.contiguous().view(torch.int32) & LOW_13_BITS


def test_tf32_round_is_round_to_nearest_ties_away():
    ulp = 2.0 ** -10  # TF32 keeps 10 mantissa bits
    cases = {
        1.0 + ulp / 2: 1.0 + ulp,          # a tie goes away from zero
        -(1.0 + ulp / 2): -(1.0 + ulp),
        1.0 + 3 * ulp / 2: 1.0 + 2 * ulp,  # ties away, not to even
        1.0 + ulp / 2 - 2.0 ** -23: 1.0,   # below the tie goes down
        3.0: 3.0,
        0.0: 0.0,
    }
    got = tf32_round(torch.tensor(list(cases), dtype=torch.float32))
    assert got.tolist() == list(cases.values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_round_trip(dtype):
    x, w1, s1, b1, w2, s2, b2 = (torch.from_numpy(a) for a in _block_inputs(1, 64))
    pack = pack_block(w1, s1, b1, w2, s2, b2, dtype)
    assert pack.dtype == dtype and pack.s1.dtype == torch.float32
    for w, packed in ((w1, pack.w1), (w2, pack.w2)):
        assert packed.dtype == dtype and packed.is_contiguous()
        if dtype == torch.bfloat16:
            assert tuple(packed.shape) == (1, 64, 9 * 64)
            torch.testing.assert_close(unpack_weight(packed), w.bfloat16(), atol=0, rtol=0)
            continue
        assert tuple(packed.shape) == (2, 64, 9 * 64)
        hi, lo = packed
        assert not _low_bits(hi).any() and not _low_bits(lo).any()
        # hi + lo is w up to lo's own TF32 rounding: 2^-11 of |w - hi|.
        err = (unpack_weight(packed) - w).abs()
        assert bool((err <= 2.0 ** -21 * w.abs()).all())
        # The K-major layout: row n, depth tap * C + c_in.
        assert hi[5, 4 * 64 + 7] == tf32_round(w[1, 1, 7, 5:6])[0]


def _conv(x, w):
    out = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    return out.permute(0, 2, 3, 1)


def _split(t):
    hi = tf32_round(t)
    return hi, tf32_round(t - hi)


def _emulated_conv(x, packed, passes):
    """The kernel's products on the packed halves: a_lo*b_hi + a_hi*b_lo +
    a_hi*b_hi, or a_hi*b_hi alone for one TF32 pass."""
    c = packed.shape[1]
    w_hi, w_lo = (h.reshape(c, 3, 3, c).permute(1, 2, 3, 0) for h in packed)
    x_hi, x_lo = _split(x)
    if passes == 1:
        return _conv(x_hi, w_hi)
    return _conv(x_lo, w_hi) + _conv(x_hi, w_lo) + _conv(x_hi, w_hi)


def _emulated_block(x, pack, passes):
    y = torch.relu(_emulated_conv(x, pack.w1, passes) * pack.s1 + pack.b1)
    return torch.relu(_emulated_conv(y, pack.w2, passes) * pack.s2 + pack.b2 + x)


# [H, W, C] of ResNet-18's identity blocks at 128-px crops: each runs on the
# kernel.
BLOCK_MAPS = [(32, 32, 64), (16, 16, 128), (8, 8, 256), (4, 4, 512)]


@pytest.mark.parametrize("hwc", BLOCK_MAPS, ids=lambda hwc: "x".join(map(str, hwc)))
def test_3xtf32_emulation_holds_the_f32_gate(hwc):
    """At every identity block's shape, three TF32 products hold the
    kernel's 1e-4 * max|ref| gate against both references; one does not."""
    args = _block_inputs(2, hwc[2], seed=3, hw=hwc[:2])
    targs = [torch.from_numpy(a) for a in args]
    pack = pack_block(*targs[1:], dtype=torch.float32)
    ref = residual_block_ref(*targs).numpy()
    xla = np.asarray(xla_residual_block(*(jnp.asarray(a) for a in args)))
    three = _emulated_block(targs[0], pack, 3).numpy()
    one = _emulated_block(targs[0], pack, 1).numpy()
    for reference in (ref, xla):
        gate = 1e-4 * np.abs(reference).max()
        assert np.abs(three - reference).max() <= gate
        assert np.abs(one - reference).max() > gate


# [B, H, W, C] of every identity block a route of the port runs: the
# embed's four stages in chunks of 48 (the VOD path), 24 (a replica of
# VodAnalyzer(mesh=)), 7 (the dashboards), 56 and 112 (the training
# evaluate passes), and the detector's trunk at 256x448 in batches of 16.
ROUTE_SHAPES = ([(b, *hwc) for b in (48, 24, 7, 56, 112) for hwc in BLOCK_MAPS]
                + [(16, 64, 112, 64), (16, 32, 56, 128), (16, 16, 28, 256), (16, 8, 14, 512)])


@pytest.mark.parametrize("shape", ROUTE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_launch_shape_fits_the_block(shape):
    """The launch's grid covers the block's rows and channels exactly (no
    empty row tile), its shared memory fits, and it splits the depth only
    where the tiles are fewer than the SMs, into halves of whole slices."""
    b, h, w, c = shape
    m = b * h * w
    bm, bn, split = launch_shape(c, m)
    assert (bm, bn) in TILES and split in (1, 2)
    row_tiles = -(-m // bm)
    assert c % bn == 0 and (row_tiles - 1) * bm < m <= row_tiles * bm
    assert launch_smem(bm, bn) <= SMEM_PER_SM
    assert split == 1 or row_tiles * (c // bn) < SMS
    assert (9 * c // 32) // split >= 9  # float32 depth slices a block


def test_launch_shape_picks():
    """The picks the card measured fastest on the main path: the depth
    split at 4x4x512, where 64 x 64 tiles would be 96 for 132 SMs, and not
    at 32x32x64, where K = 576 is already short and 768 tiles fill the card."""
    assert launch_shape(512, 48 * 16) == (64, 128, 2)
    assert launch_shape(256, 48 * 64) == (128, 128, 2)
    assert launch_shape(128, 48 * 256) == (128, 128, 1)
    assert launch_shape(64, 48 * 1024) == (64, 64, 1)
    assert launch_shape(64, 7 * 1024) == (64, 64, 2)
    with pytest.raises(ValueError):
        launch_shape(96, 48 * 1024)


def test_packed_block_on_cpu_runs_the_plain_version():
    targs = [torch.from_numpy(a) for a in _block_inputs(3, 64, seed=1)]
    pack = pack_block(*targs[1:], dtype=torch.float32)
    before = residual_block_packed.launches
    out = residual_block_packed(targs[0], pack)
    torch.testing.assert_close(out, residual_block_ref(*targs), atol=1e-5, rtol=0)
    first = residual_block_packed(targs[0], pack, channels_first=True)
    assert torch.equal(first, out) and first.permute(0, 3, 1, 2).is_contiguous()
    assert residual_block_packed.launches == before
    with pytest.raises(TypeError):
        residual_block_packed(targs[0].bfloat16(), pack)


def _fused_block(seed):
    torch.manual_seed(seed)
    block = BasicBlock(64, 64, fused=True)
    with torch.no_grad():
        for bn in (block.bn1, block.bn2):
            bn.running_mean.uniform_(-0.1, 0.1)
            bn.running_var.uniform_(0.5, 1.5)
    return block.eval()


def _assert_pack_matches(block, pack):
    for conv, packed in ((block.conv1, pack.w1), (block.conv2, pack.w2)):
        torch.testing.assert_close(unpack_weight(packed), conv.weight.permute(2, 3, 1, 0),
                                   atol=1e-6, rtol=0)
    s2, b2 = fold_batch_norm(block.bn2)
    torch.testing.assert_close(pack.s2, s2.detach(), atol=0, rtol=0)
    torch.testing.assert_close(pack.b2, b2.detach(), atol=0, rtol=0)


def test_block_pack_cache_never_serves_stale_weights():
    block = _fused_block(0)
    first = block.block_pack(torch.float32)
    assert block.block_pack(torch.float32) is first  # kept while nothing changed
    _assert_pack_matches(block, first)

    block.load_state_dict(_fused_block(1).state_dict())
    reloaded = block.block_pack(torch.float32)
    assert reloaded is not first
    _assert_pack_matches(block, reloaded)

    with torch.no_grad():
        block.conv2.weight.mul_(2.0)
    edited = block.block_pack(torch.float32)
    assert edited is not reloaded
    _assert_pack_matches(block, edited)

    block.train()
    block(torch.randn(2, 64, 4, 4))  # a training step moves the running statistics
    block.eval()
    after_training = block.block_pack(torch.float32)
    assert after_training is not edited
    _assert_pack_matches(block, after_training)

    assert block.block_pack(torch.bfloat16).dtype == torch.bfloat16


@pytest.mark.parametrize("arch,fused", [("resnet18", 5), ("resnet34", 13), ("resnet50", 0)])
def test_every_identity_block_is_fused(arch, fused):
    """A BasicBlock runs on the kernel exactly when it has no projection:
    stride 1 and as many channels in as out.  ResNet-50 has none."""
    net = make_resnet(arch)
    blocks = [m for m in net.modules() if isinstance(m, (BasicBlock, Bottleneck))]
    assert blocks
    basic = [m for m in blocks if isinstance(m, BasicBlock)]
    assert (not basic) == (arch == "resnet50")
    for b, after in zip(basic, basic[1:] + [None]):
        identity = b.conv1.stride == (1, 1) and b.conv1.in_channels == b.conv1.out_channels
        assert b.fused == identity == (b.downsample is None)
        # A run of fused blocks hands cuDNN its output channels first.
        assert b.channels_first_out == (after is None or not after.fused)
    assert sum(b.fused for b in basic) == fused


def test_fused_resnet_runs_the_plain_path_on_cpu():
    """Eval mode on CPU tensors: no launch, the same numbers as the net
    with no block fused."""
    torch.manual_seed(0)
    fused = make_resnet("resnet18", num_classes=10)
    with torch.no_grad():
        for m in fused.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.1, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    plain = make_resnet("resnet18", num_classes=10)
    plain.load_state_dict(fused.state_dict())
    for m in plain.modules():
        if isinstance(m, BasicBlock):
            m.fused = False
    x = torch.rand(2, 3, 64, 64)
    before = residual_block_packed.launches
    with torch.no_grad():
        torch.testing.assert_close(fused.eval()(x), plain.eval()(x), atol=0, rtol=0)
    assert residual_block_packed.launches == before


def test_fused_block_counts_into_its_span():
    """Each fused call adds one ``k2_blocks`` to the enclosing span; a
    block that hands a fused block on keeps its output channels last."""
    block = _fused_block(2)
    x = torch.rand(2, 64, 8, 8)
    with profiling.recording() as rec:
        with profiling.span("playaid.embed", crops=2):
            block.channels_first_out = False
            mid = block._fused_forward(x)
            block.channels_first_out = True
            out = block._fused_forward(mid)
    assert rec.summary()["playaid.embed"]["k2_blocks"] == 2
    assert mid.is_contiguous(memory_format=torch.channels_last) and out.is_contiguous()
    with torch.no_grad():
        torch.testing.assert_close(out, block(block(x)), atol=1e-5, rtol=0)


@pytest.mark.parametrize("caller_flag", [True, False])
def test_embed_crops_runs_without_tf32(caller_flag):
    """The entry point turns TF32 off for its own convolutions and gives the
    caller's flags back."""
    pipe = BatchedActionPipeline(device="cpu")
    seen = []
    hook = pipe.embed.conv1.register_forward_hook(
        lambda *_: seen.append((torch.backends.cudnn.allow_tf32,
                                torch.backends.cuda.matmul.allow_tf32)))
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = caller_flag
        torch.backends.cuda.matmul.allow_tf32 = caller_flag
        pipe.embed_crops(torch.rand(1, 32, 32, 3))
        assert seen == [(False, False)]
        assert torch.backends.cudnn.allow_tf32 is caller_flag
        assert torch.backends.cuda.matmul.allow_tf32 is caller_flag
    finally:
        hook.remove()
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
