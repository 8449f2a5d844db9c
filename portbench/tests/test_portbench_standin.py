"""The stand-in hands out the pool's data: chunks are gathers of the pool's
crops."""

import numpy as np

from portbench.tests.helpers import TINY_TRAFFIC
from portbench import standin


def _pool(seed=5):
    return standin.Pool(TINY_TRAFFIC, seed), standin.Schedule(TINY_TRAFFIC, seed)


def test_chunks_are_the_pools_crops():
    pool, schedule = _pool()
    crops = pool.crops(32, 4)
    src = standin.CropSource(crops, schedule, vod=3, size=32, padding=4)
    n, chunk = src.decode_crops(48, np.zeros((48, 2, 4), np.float32), 32, 4, stride=2,
                                fmt="yuv420", dense=True)
    assert n == 48 and chunk.shape == (24, 2, 32 * 32 * 3 // 2)
    scenes = schedule.scenes(3, 48 + 2 * np.arange(24))
    assert np.array_equal(chunk, crops[scenes])


def test_rows_past_the_end_are_zero():
    pool, schedule = _pool()
    crops = pool.crops(32, 4)
    src = standin.CropSource(crops, schedule, vod=0, size=32, padding=4)
    n, chunk = src.decode_crops(72, np.zeros((48, 2, 4), np.float32), 32, 4, stride=2,
                                fmt="yuv420", dense=True)
    assert n == 24 and not chunk[12:].any() and np.array_equal(
        chunk[:12], crops[schedule.scenes(0, 72 + 2 * np.arange(12))])


def test_crops_are_cut_from_the_frames():
    pool, _ = _pool()
    crops = pool.crops(32, 4)
    i = 5
    frame = pool.render(i, np.empty((pool.h, pool.w, 3), np.uint8))
    for k in range(2):
        assert np.array_equal(crops[i, k], standin.yuv420_crop(frame, pool.boxes[i, k], 32, 4))


def test_schedule_holds_moves_for_a_segment():
    _, schedule = _pool()
    scenes = schedule.scenes(2, np.arange(96))
    moves = scenes // TINY_TRAFFIC["phases"]
    seg = TINY_TRAFFIC["segment_frames"]
    assert all(len(set(moves[s:s + seg])) == 1 for s in range(0, 96, seg))
    assert np.array_equal(scenes % 4, (np.arange(96) // 5) % 4)


def test_same_seed_same_inputs():
    (p1, s1), (p2, s2) = _pool(9), _pool(9)
    assert np.array_equal(p1.crops(32, 4), p2.crops(32, 4))
    assert np.array_equal(s1.table, s2.table)
    assert not np.array_equal(s1.table, _pool(10)[1].table)
