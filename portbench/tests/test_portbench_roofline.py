"""The work counted from shapes, against the arithmetic of the cells."""

import pytest

from portbench import roofline
from portbench.catalog import Catalog
from portbench.tests.helpers import benchmark

CATALOG = Catalog(benchmark())


def test_k4_bytes_of_a_chunk():
    # 48 crops: 48 x 24,576 B of YUV420 in, 48 x 3 x 128^2 float32 out.
    assert roofline.k4_bytes(48, 128) == 10_616_832


def test_k2_operations_once():
    flops, nbytes = roofline.k2_counts(48, 512, (4, 4))
    assert flops == 2 * 2 * 48 * 16 * 512 * 512 * 9 == 7_247_757_312  # 7.25 GFLOP, not 3x
    assert nbytes == 2 * 48 * 16 * 512 * 4 + 2 * 9 * 512 * 512 * 4 + 4 * 512 * 4


def test_h2d_bytes_a_frame():
    # One 128^2 YUV420 crop a fighter, two fighters, every second frame.
    assert roofline.h2d_bytes_per_frame(128, stride=2) == 24_576


@pytest.mark.parametrize("arch,gflop", [("resnet18", 1.1844), ("resnet50", 2.6692)])
def test_resnet_operations(arch, gflop):
    assert roofline.resnet_flops(arch, 128) / 1e9 == pytest.approx(gflop, abs=1e-4)


def test_frame_operations():
    cnn = {"family": "cnn", "crop_size": 128, "embed_dim": 1000, "sequence_length": 7,
           "num_actions": 63, "head": {"dense": 512, "hidden": 128}}
    per_frame = roofline.frame_flops(cnn, stride=2, family=CATALOG.family("cnn"))
    head = 2 * (7000 * 512 + 512 * 128 + 128 * 63)
    assert per_frame == roofline.resnet_flops("resnet18", 128) + 2 * 512 * 1000 + head


def test_least_time_takes_the_larger_bound():
    assert roofline.least_s(495e12, 0) == pytest.approx(1.0)
    assert roofline.least_s(0, 3.35e12) == pytest.approx(1.0)
    assert roofline.least_s(495e12, 2 * 3.35e12) == pytest.approx(2.0)


@pytest.mark.parametrize("name,trunk,features,flops", [
    ("cnn63", "resnet18", 512, 1_192_705_792), ("resformer", "resnet50", 2048, 2_725_588_480)])
def test_frame_operations_of_each_config(name, trunk, features, flops):
    """Each committed configuration's count a frame, through the family
    its ``family`` names: the trunk's count of ``test_resnet_operations``
    and the dense layer to the embedding, then the head."""
    config = CATALOG.config(name)
    family = CATALOG.family(config["family"])
    assert roofline.frame_flops(config, stride=2, family=family) == flops
    embed = roofline.resnet_flops(trunk, 128) + 2 * features * config["embed_dim"]
    assert family.embed_flops(config) == embed
    assert family.head_flops(config) == flops - embed


def test_k2_blocks_of_each_family():
    """The CNN family's five identity blocks of ResNet-18 at 128 px, each
    7.25 GFLOP at 48 crops; the ResFormer none."""
    cnn = CATALOG.config("cnn63")
    blocks = CATALOG.family("cnn").k2_blocks(cnn)
    assert blocks == [(64, 32, 32), (64, 32, 32), (128, 16, 16), (256, 8, 8), (512, 4, 4)]
    assert sum(roofline.k2_counts(48, c, (h, w))[0] for c, h, w in blocks) == 5 * 7_247_757_312
    assert roofline.identity_blocks("resnet18", 64) == [(c, h // 2, w // 2) for c, h, w in blocks]
    assert CATALOG.family("resformer").k2_blocks(CATALOG.config("resformer")) == []
